"""Parity of the port's Mamba block (``repro_torch.models.mamba``) with the
JAX package's on the CPU.

- ``mamba_apply`` (the log-depth parallel scan) against the reference's
  ``associative_scan`` over several sequence lengths, without a scan
  chunk and with one (S a multiple of the chunk runs the chunked carry;
  S not a multiple, or not above it, runs the whole scan, as in the
  reference), and the chunked port run against its unchunked one.
- A ``mamba_decode`` loop against the reference's, outputs and states,
  and against the port's own ``mamba_apply`` of the whole sequence.
- Gradients of ``mamba_apply`` (every parameter and the input) against
  ``jax.grad`` of the reference.
- ``init_mamba`` gives the reference's shapes and dtypes (``A_log``,
  ``D`` and ``b_dt`` float32, the rest the model dtype).

The weights are the reference's ``init_mamba`` (as numpy); float32, d 64
(d_inner 128, dt_rank 4, d_state 16); rtol = atol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import mamba as jmamba
from repro_torch.models import mamba

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
D, B = 64, 2


def close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL)


def configs(chunk=0, dtype="float32"):
    return (jmamba.MambaConfig(d_model=D, dtype=jnp.dtype(dtype),
                               scan_chunk=chunk),
            mamba.MambaConfig(d_model=D, dtype=getattr(torch, dtype),
                              scan_chunk=chunk))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = configs()
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def inputs(S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def test_mamba_apply_matches_reference(weights):
    """S = 1, 7 (below the chunk), 20 (not a multiple of it), 24 and 64
    (3 and 8 chunks of 8)."""
    jp, p = weights
    for chunk in (0, 8):
        jcfg, cfg = configs(chunk)
        fn = jax.jit(lambda prm, x, c=jcfg: jmamba.mamba_apply(prm, x, c))
        for S in (1, 7, 20, 24, 64):
            x = inputs(S, seed=S)
            got = mamba.mamba_apply(p, torch.from_numpy(x), cfg)
            close(got, fn(jp, jnp.asarray(x)))
            if chunk:
                close(got, np.asarray(mamba.mamba_apply(
                    p, torch.from_numpy(x), configs()[1])))


def test_mamba_decode_loop_matches_reference_and_apply(weights):
    jp, p = weights
    jcfg, cfg = configs()
    S = 12
    x = inputs(S, seed=1)
    whole = mamba.mamba_apply(p, torch.from_numpy(x), cfg)
    jstep = jax.jit(lambda prm, xt, st: jmamba.mamba_decode(prm, xt, st,
                                                            jcfg))
    jstate = jmamba.init_mamba_state(B, jcfg)
    state = mamba.init_mamba_state(B, cfg, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        "h": ((B, 2 * D, 16), torch.float32),
        "conv": ((B, 3, 2 * D), torch.float32)}
    for t in range(S):
        xt = x[:, t:t + 1]
        jout, jstate = jstep(jp, jnp.asarray(xt), jstate)
        out, state = mamba.mamba_decode(p, torch.from_numpy(xt), state, cfg)
        close(out, jout)
        close(out, whole[:, t:t + 1])
        for k in ("h", "conv"):
            close(state[k], jstate[k])


def test_mamba_apply_gradients_match_reference(weights):
    jp, p = weights
    for chunk in (0, 8):
        jcfg, cfg = configs(chunk)
        S = 16
        x = inputs(S, seed=2)
        r = np.random.default_rng(3).standard_normal(
            (B, S, D)).astype(np.float32)

        def jloss(prm, xx):
            return jnp.sum(jmamba.mamba_apply(prm, xx, jcfg) * r)

        jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp,
                                                            jnp.asarray(x))
        tp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        (mamba.mamba_apply(tp, tx, cfg) * torch.from_numpy(r)).sum().backward()
        close(tx.grad, jgx)
        assert set(tp) == set(jgp)
        for k in tp:
            close(tp[k].grad, jgp[k])


def test_init_mamba_matches_reference_shapes_and_dtypes():
    """At bf16, Jamba's model dtype; and at Jamba's width (d 4096) the
    derived widths: d_inner 8192 and dt_rank 256."""
    jcfg = jmamba.MambaConfig(d_model=D, dtype=jnp.bfloat16)
    cfg = mamba.MambaConfig(d_model=D, dtype=torch.bfloat16)
    want = jax.eval_shape(lambda k: jmamba.init_mamba(k, jcfg),
                          jax.random.PRNGKey(0))
    got = mamba.init_mamba(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == v.dtype.name, k
    assert {k for k, v in got.items() if v.dtype == torch.float32} == {
        "A_log", "D", "b_dt"}
    for p, jp in ((cfg, jcfg), (mamba.MambaConfig(d_model=4096),
                                jmamba.MambaConfig(d_model=4096))):
        assert (p.d_inner, p.dt_rank_) == (jp.d_inner, jp.dt_rank_)
    assert mamba.MambaConfig(d_model=4096).dt_rank_ == 256
