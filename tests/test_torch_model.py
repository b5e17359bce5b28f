"""Parity of the PyTorch port (``repro_torch``) with the JAX package on the
CPU: the gate, the gather dispatch path (fused and unfused branches, all
of ``METRIC_KEYS``), the attention layer (with and without the flash
entry), decode attention, and the fused prefill's logits and caches.

Both packages compute with the same weights: the JAX params are made by
``repro.models.model.init_params`` and passed across as numpy through
``repro_torch.models.convert.params_from_numpy``; inputs are made by numpy
from a seed.  Size: ``gpt3_medium_moe.reduced()`` in float32 (2 layers,
d=256, 4 experts).  Tolerances: rtol = atol = 1e-4 on float32 layer
outputs; 1e-3 abs on logits (the float32 sums over 512 vocabulary rows
run in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sharding
from repro.configs.base import get_config as jax_get_config
from repro.core import gating as jgating
from repro.core.dispatch import engine as jdispatch_lib
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro_torch.configs.base import get_config
from repro_torch.core import gating
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.models import decode, layers, model, transformer
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

ARCH_ID = "gpt3_medium_moe"
TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_ATOL = 1e-3


def build_ctxs(mesh11, **kw):
    """(jax ctx, port ctx) of the reduced arch with the same options;
    ``use_pallas`` applies to both."""
    use_pallas = kw.pop("use_pallas", None)
    jarch = jax_get_config(ARCH_ID).reduced()
    jctx = jmodel.build_ctx(jarch, mesh11, seq_len=32, global_batch=4,
                            use_pallas=use_pallas, **kw)
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), use_pallas=use_pallas,
                          device="cpu", **kw)
    return jctx, ctx


def build_params(mesh11, key):
    """(jax params, port params) on the same weights; they do not depend
    on the ctx options ``build_ctxs`` varies."""
    jctx, ctx = build_ctxs(mesh11, aux_mode="none")
    with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
        jparams = jmodel.init_params(key, jctx)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(tree, ctx, "cpu")


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def weights(mesh11, key):
    return build_params(mesh11, key)


@pytest.fixture(scope="module")
def pair(mesh11, weights):
    jctx, ctx = build_ctxs(mesh11, aux_mode="none")
    return jctx, weights[0], ctx, weights[1]


def test_configs_match_reference():
    jarch, arch = jax_get_config(ARCH_ID), get_config(ARCH_ID)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "vocab_size", "norm", "activation", "dtype"):
        assert getattr(arch, f) == getattr(jarch, f), f
    assert dataclasses.asdict(arch.moe) == dataclasses.asdict(jarch.moe)
    r, jr = arch.reduced(), jarch.reduced()
    assert (r.num_layers, r.d_model, r.moe.num_experts, r.dtype) == \
        (jr.num_layers, jr.d_model, jr.moe.num_experts, jr.dtype)
    # layer_plan ignores moe_period in both packages: every layer is MoE
    assert [s.ffn for s in transformer.layer_list(arch)] == ["moe"] * 12
    # every path of the reference registry is ported; others are refused
    assert dispatch_lib.available() == jdispatch_lib.available()
    ctx = model.build_ctx(r, device="cpu")
    with pytest.raises(ValueError, match="registered paths"):
        dispatch_lib.make_engine("nope", cfg=ctx.moe_cfg, ep=ctx.ep,
                                 gate_cfg=ctx.gate_cfg)
    with pytest.raises(ValueError, match="registered paths"):
        model.build_ctx(r, dispatch="nope", device="cpu")


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aux_mode", ["lb", "ta", "hir", "none"])
def test_gate_forward_and_aux_loss(aux_mode):
    rng = np.random.default_rng(0)
    T, d, N = 24, 32, 8
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((d, N)).astype(np.float32) * 0.3
    levels = np.asarray([0, 0, 1, 1, 2, 2, 2, 2], np.int32)
    pen = (1.0, 1.4, 2.2)
    jcfg = jgating.GateConfig(num_experts=N, top_k=2, aux_mode=aux_mode,
                              penalty_by_level=pen)
    cfg = gating.GateConfig(num_experts=N, top_k=2, aux_mode=aux_mode,
                            penalty_by_level=pen)
    jout = jgating.gate_forward({"w": jnp.asarray(w)}, jnp.asarray(x), jcfg,
                                jnp.asarray(levels))
    out = gating.gate_forward({"w": t(w)}, t(x), cfg, t(levels, torch.int64))
    for k in ("logits", "probs", "topk_weight"):
        close(out[k], jout[k])
    np.testing.assert_array_equal(np.asarray(out["topk_idx"]),
                                  np.asarray(jout["topk_idx"]))
    close(gating.aux_loss(out, cfg, t(levels, torch.int64)),
          jgating.aux_loss(jout, jcfg, jnp.asarray(levels)))
    frac = gating.dispatch_fractions(out["topk_idx"], N)
    close(frac, jgating.dispatch_fractions(jout["topk_idx"], N))
    close(gating.frac_by_level(frac, t(levels, torch.int64), 2),
          jgating.frac_by_level(jnp.asarray(np.asarray(frac)),
                                jnp.asarray(levels), 2))


def test_topk_ties_follow_lax_top_k():
    row = np.full((1, 32), -1.0, np.float32)
    row[0, [1, 3, 4, 7, 9, 12, 23]] = 0.5
    vals, idx = gating.topk_stable(t(row), 6)
    jvals, jidx = jax.lax.top_k(jnp.asarray(row), 6)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(jidx))
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(jvals))


@pytest.mark.parametrize("sizes,coords", [((2, 4), (1, 2)), ((4,), (3,)),
                                          ((2, 2, 2), (0, 1, 1))])
def test_expert_levels_nd(sizes, coords):
    got = gating.expert_levels_nd(16, 2, sizes, coords)
    want = jgating.expert_levels_nd(16, 2, sizes, coords)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# gather dispatch path, both branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aux_mode", ["lb", "ta"])
@pytest.mark.parametrize("fused", [False, True])
def test_gather_path_parity(mesh11, weights, aux_mode, fused):
    jparams, params = weights
    jctx, ctx = build_ctxs(mesh11, aux_mode=aux_mode, use_pallas=fused)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, ctx.arch.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["groups"])["sub0"]
    jy, jm = jax.jit(lambda p, xx: jtransformer._moe_block(
        p, xx, jctx, decode=True, layer_idx=1))(jp["ffn"], jnp.asarray(x))
    y, m = transformer._moe_block(params["layers"][1]["ffn"], t(x), ctx,
                                  decode=True, layer_idx=1)
    close(y, jy)
    assert set(m) == set(dispatch_lib.METRIC_KEYS) == set(jm)
    for k in dispatch_lib.METRIC_KEYS:
        close(m[k], jm[k])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm", "nonparam_ln"])
def test_norm_and_rope(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    close(layers.norm_apply(tp, t(x), kind),
          jlayers.norm_apply(jp, jnp.asarray(x), kind))
    pos = np.asarray([3, 0, 7, 1, 100], np.int32)
    close(layers.apply_rope(t(x), t(pos)),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("use_flash", [False, True])
def test_attn_apply_parity(pair, use_flash):
    jctx, jparams, ctx, params = pair
    jcfg = dataclasses.replace(jctx.attn_cfg, use_flash_kernel=use_flash)
    cfg = dataclasses.replace(ctx.attn_cfg, use_flash_kernel=use_flash)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, ctx.arch.d_model)).astype(np.float32)
    jout, (jk, jv) = jlayers.attn_apply(jp["sub0"]["mixer"], jnp.asarray(x),
                                        jcfg)
    out, (k, v) = layers.attn_apply(params["layers"][0]["mixer"], t(x), cfg)
    close(out, jout)
    close(k, jk)
    close(v, jv)


def test_attn_decode_parity(pair):
    jctx, jparams, ctx, params = pair
    cfg = ctx.attn_cfg
    rng = np.random.default_rng(4)
    B, L = 3, 16
    kc = rng.standard_normal((B, L, cfg.num_kv_heads,
                              cfg.head_dim)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos = np.asarray([0, 5, 15], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"])
    jout, jc = jlayers.attn_decode(
        jp["sub0"]["mixer"], jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc), "pos": jnp.asarray(pos)},
        jctx.attn_cfg)
    out, c = layers.attn_decode(params["layers"][0]["mixer"], t(x),
                                {"k": t(kc), "v": t(vc), "pos": t(pos)}, cfg)
    close(out, jout)
    for name in ("k", "v", "pos"):
        close(c[name], jc[name])


# ---------------------------------------------------------------------------
# fused prefill
# ---------------------------------------------------------------------------


def jax_prefill(jctx, jparams, tokens, lens, cache_len):
    return jax.jit(lambda p, tk, ln: jdecode.prefill(
        p, {"tokens": tk}, jctx, cache_len=cache_len, lens=ln))(
            jparams, jnp.asarray(tokens), jnp.asarray(lens))


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_logits_and_caches(mesh11, weights, use_flash):
    jparams, params = weights
    jctx, ctx = build_ctxs(mesh11, aux_mode="none", use_flash=use_flash)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, ctx.arch.vocab_size, size=(3, 16)).astype(
        np.int32)
    lens = np.asarray([16, 9, 1], np.int32)
    jlast, jcache = jax_prefill(jctx, jparams, tokens, lens, 24)
    last, cache = decode.prefill(params, {"tokens": t(tokens)}, ctx,
                                 cache_len=24, lens=t(lens))
    close(last, jlast, rtol=0, atol=LOGIT_ATOL)
    assert len(cache) == ctx.arch.num_layers
    for i, layer in enumerate(cache):
        jc = jcache["groups"]["sub0"]["mixer"]
        for name in ("k", "v", "pos"):
            close(layer["mixer"][name], np.asarray(jc[name])[i])
