"""Parity of the port's Multi-head Latent Attention, blockwise attention
and ring topology with the JAX package on the CPU.

- ``mla.mla_apply`` (expanded form) against the reference's, with the
  full-rank query (``q_lora_rank`` 0, DeepSeek-V2-Lite) and the low-rank
  one (32, DeepSeek-V2 236b's branch), attention plain and blockwise:
  output and the cache entries at rtol = atol = 1e-4.
- ``layers._blockwise_sdpa`` against the reference's with a value dim
  unlike the qk dim (MLA's case), GQA, causal, windowed and not causal,
  over several key blocks: 1e-5, as ``tests/test_perf_flags.py`` holds
  the reference's.
- ``mla.mla_decode`` (absorbed form, the latent cache updated in place)
  step by step against the port's own expanded form at the reference's
  ``tests/test_decode.py`` tolerances (atol 2e-4, rtol 2e-3), and against
  the reference's ``mla_decode`` at 1e-4, caches included.
- ``topology.RingTopology`` (paper Fig. 2(b)) as ``tests/test_topology.py``
  holds the reference's, and against the reference's level matrix,
  ``target_dispatch`` and ``per_level_ratios``.

Weights come from the reference's ``init_mla``, passed over as numpy;
inputs are made by numpy from a seed; float32 throughout.  The MLA widths
are DeepSeek-V2's ``reduced()`` ones (d 256, 4 heads, rank 64, qk 32 + 16,
v 32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import topology as jtopology
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro_torch.configs.base import get_config
from repro_torch.core import topology
from repro_torch.models import layers, mla

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 12


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def t(a):
    return torch.from_numpy(np.array(a))


def tree_t(tree):
    if isinstance(tree, dict):
        return {k: tree_t(v) for k, v in tree.items()}
    return t(tree)


def cfgs(q_lora_rank=0, use_blockwise=False):
    """(reference, port) MLA configs at DeepSeek-V2-Lite's reduced widths."""
    a = get_config("deepseek_v2_lite_16b").reduced()
    m = a.mla
    kw = dict(d_model=a.d_model, num_heads=a.num_heads,
              kv_lora_rank=m.kv_lora_rank, qk_nope_dim=m.qk_nope_dim,
              qk_rope_dim=m.qk_rope_dim, v_dim=m.v_dim,
              q_lora_rank=q_lora_rank, use_blockwise=use_blockwise)
    return (jmla.MLAConfig(dtype=jnp.float32, **kw),
            mla.MLAConfig(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    """The reference's ``init_mla`` for both query branches, as (jax, port)
    parameter pairs."""
    out = {}
    init = jax.jit(jmla.init_mla, static_argnums=1)
    for q_lora_rank in (0, 32):
        jcfg, _ = cfgs(q_lora_rank)
        jp = init(jax.random.PRNGKey(q_lora_rank + 1), jcfg)
        out[q_lora_rank] = (jp, tree_t(jax.tree_util.tree_map(np.asarray,
                                                              jp)))
    return out


def x_input(d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


@pytest.mark.parametrize("q_lora_rank", [0, 32])
def test_mla_apply_matches_reference(weights, q_lora_rank):
    """Both query branches, attention plain and blockwise."""
    jp, p = weights[q_lora_rank]
    assert ("w_dq" in p) == bool(q_lora_rank) and ("w_q" in p) != bool(
        q_lora_rank)
    x = x_input(cfgs()[1].d_model)
    japply = jax.jit(jmla.mla_apply, static_argnums=2)
    for use_blockwise in (False, True):
        jcfg, cfg = cfgs(q_lora_rank, use_blockwise)
        jout, jentry = japply(jp, jnp.asarray(x), jcfg)
        out, entry = mla.mla_apply(p, t(x), cfg)
        close(out, jout)
        for k in ("c_kv", "k_rope"):
            close(entry[k], jentry[k])


def test_init_mla_has_the_reference_leaves(weights):
    """The port's own ``init_mla`` gives the reference's leaves, shapes and
    dtypes for both query branches."""
    for q_lora_rank, (jp, _) in weights.items():
        _, cfg = cfgs(q_lora_rank)
        own = mla.init_mla(dataclasses.replace(cfg, dtype=torch.bfloat16),
                           torch.Generator().manual_seed(0), "cpu")
        want = jax.tree_util.tree_leaves_with_path(jp)
        got = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(own)}
        assert set(got) == {jax.tree_util.keystr(k) for k, _ in want}
        for k, v in want:
            g = got[jax.tree_util.keystr(k)]
            assert tuple(g.shape) == v.shape
            norm = "norm" in jax.tree_util.keystr(k)
            assert g.dtype == (torch.float32 if norm else torch.bfloat16)


def test_blockwise_sdpa_matches_reference():
    """Causal, windowed and not causal, over four key blocks."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 50, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 50, 2, 24)).astype(np.float32)
    v = rng.standard_normal((2, 50, 2, 16)).astype(np.float32)
    pos = torch.arange(50)
    for causal, window in ((True, 0), (True, 16), (False, 0)):
        want = jlayers._blockwise_sdpa(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       sliding_window=window, block_k=16)
        got = layers._blockwise_sdpa(t(q), t(k), t(v), causal=causal,
                                     sliding_window=window, block_k=16)
        assert tuple(got.shape) == (2, 50, 4, 16)
        close(got, want, rtol=1e-5, atol=1e-5)
        # with v of the qk dim, the blockwise path equals the plain one
        plain = layers._sdpa(t(q), t(k), t(k), causal=causal,
                             sliding_window=window, q_positions=pos,
                             k_positions=pos)
        close(layers._blockwise_sdpa(t(q), t(k), t(k), causal=causal,
                                     sliding_window=window, block_k=16),
              plain, rtol=1e-5, atol=1e-5)


def test_attn_apply_blockwise_branch():
    """``AttnConfig.use_blockwise``: ``attn_apply`` through the blockwise
    branch equals its plain branch (the reference's
    ``test_blockwise_attention_matches`` tolerances)."""
    cfg = layers.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2,
                            head_dim=8, dtype=torch.float32)
    p = layers.init_attn(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 20, 32)).astype(np.float32))
    plain, _ = layers.attn_apply(p, x, cfg)
    blockwise, _ = layers.attn_apply(
        p, x, dataclasses.replace(cfg, use_blockwise=True))
    close(blockwise, plain, atol=2e-4, rtol=1e-3)


def test_mla_decode_matches_expanded_form_and_reference(weights):
    """Both query branches, step by step from an empty cache; then two
    requests at different cache positions in one step: each row's RoPE
    angle and validity mask follow its own ``pos``."""
    jdecode = jax.jit(jmla.mla_decode, static_argnums=3)
    for q_lora_rank in (0, 32):
        jcfg, cfg = cfgs(q_lora_rank)
        jp, p = weights[q_lora_rank]
        x = x_input(cfg.d_model, seed=3)
        full, _ = mla.mla_apply(p, t(x), cfg)
        cache = mla.init_mla_cache(B, S, cfg, "cpu")
        jcache = jmla.init_mla_cache(B, S, jcfg)
        buffers = (cache["c_kv"], cache["k_rope"])
        for i in range(S):
            out, cache = mla.mla_decode(p, t(x[:, i:i + 1]), cache, cfg)
            jout, jcache = jdecode(jp, jnp.asarray(x[:, i:i + 1]), jcache,
                                   jcfg)
            close(out, jout)
            close(out[:, 0], full[:, i], atol=2e-4, rtol=2e-3)
        assert cache["c_kv"] is buffers[0] and cache["k_rope"] is buffers[1]
        for k in ("c_kv", "k_rope", "pos"):
            close(cache[k], jcache[k])

    jcfg, cfg = cfgs(0)
    jp, p = weights[0]
    rng = np.random.default_rng(4)
    c_kv = rng.standard_normal((B, S, cfg.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((B, S, cfg.qk_rope_dim)).astype(np.float32)
    pos = np.asarray([3, 9], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jout, jc = jdecode(jp, jnp.asarray(x), {
        "c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope),
        "pos": jnp.asarray(pos)}, jcfg)
    out, c = mla.mla_decode(p, t(x), {"c_kv": t(c_kv), "k_rope": t(k_rope),
                                      "pos": t(pos)}, cfg)
    close(out, jout)
    for k in ("c_kv", "k_rope", "pos"):
        close(c[k], jc[k])


# ---------------------------------------------------------------------------
# the ring topology (planning only)
# ---------------------------------------------------------------------------


def test_ring_hop_levels_and_sizes():
    r = topology.RingTopology(8)
    assert r.level(0, 1) == 1
    assert r.level(0, 7) == 1      # wraparound
    assert r.level(0, 4) == 4
    assert r.num_levels == 5
    assert r.is_symmetric()
    assert list(topology.RingTopology(6).level_sizes()) == [1, 2, 2, 1]
    for P in (2, 5, 6, 8):
        jr, r = jtopology.RingTopology(P), topology.RingTopology(P)
        np.testing.assert_array_equal(r.level_matrix(), jr.level_matrix())
        assert r.num_levels == jr.num_levels
        for i in range(P):
            np.testing.assert_array_equal(r.level_sizes(i),
                                          jr.level_sizes(i))
            assert [r.level(i, j) for j in range(P)] == \
                [jr.level(i, j) for j in range(P)]


def test_eq7_on_ring_matches_reference():
    """Eq. (7) on rings of 6 and 8 whose per-hop bandwidth decays with
    distance: the dispatch conserves tokens per row and column, nearer hops
    carry more, and ``target_dispatch`` and ``per_level_ratios`` equal the
    reference's."""
    for P in (6, 8):
        _eq7_on_ring(P)


def _eq7_on_ring(P):
    r, jr = topology.RingTopology(P), jtopology.RingTopology(P)
    beta = tuple(1.0 / (200e9 / max(h, 1)) for h in range(r.num_levels))
    alpha = (0.0,) * r.num_levels
    m = topology.CommModel(topo=r, alpha=alpha, beta=beta)
    jm = jtopology.CommModel(topo=jr, alpha=alpha, beta=beta)
    c = topology.target_dispatch(m, tokens_sent=600.0, experts_per_device=2)
    np.testing.assert_allclose(c.sum(1), 600.0, rtol=1e-9)
    np.testing.assert_allclose(c.sum(0), 300.0, rtol=1e-9)
    assert c[0, 2] > c[0, 4] > c[0, 6]
    assert c[0, 2] == pytest.approx(2 * c[0, 4], rel=1e-6)
    np.testing.assert_allclose(
        c, jtopology.target_dispatch(jm, tokens_sent=600.0,
                                     experts_per_device=2), rtol=1e-12)
    ratios = topology.per_level_ratios(m)
    np.testing.assert_allclose(ratios, jtopology.per_level_ratios(jm),
                               rtol=1e-12)
    assert float((ratios * r.level_sizes()).sum()) == pytest.approx(P)
    a, b = m.alpha_beta_matrices()
    ja, jb = jm.alpha_beta_matrices()
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    assert m.p2p_time(0, 3, 1e6) == jm.p2p_time(0, 3, 1e6)
