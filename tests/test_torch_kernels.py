"""Parity of the port's kernel entries (plain versions, on the CPU) with the
JAX package's kernels and references.

- K4 ``moe_fused.local_moe`` against JAX's ``local_moe_ref`` and against
  JAX's ``local_moe(..., use_pallas=True)``, which runs the Pallas kernel
  under the interpreter on the CPU (as ``tests/test_moe_fused.py`` does),
  on the gather path's slot layouts at 0/50/100% occupancy with garbage
  tokens and weights parked past ``rows_valid``.
- K5 ``flash_attn.flash_attention`` against ``flash_attention_pallas(...,
  interpret=True)`` and ``layers._sdpa``: causal, windowed, GQA, and an Sq
  that is not a multiple of the block.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
Inputs are made by numpy from a seed; tolerance rtol = atol = 1e-4 in
float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.moe_fused import ops as jfused_ops
from repro.kernels.moe_fused.ref import local_moe_ref as jlocal_moe_ref
from repro.kernels.moe_gemm import ops as jgemm_ops
from repro.models import layers as jlayers
from repro_torch.core.dispatch import transport
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.moe_fused import ops as fused_ops
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.moe_permute import ref as permute_ref

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def gather_layout(rng, Tg, E, occupancy, garbage=True):
    """The gather path's dense [E, Tg] slot grid (slot ``e * Tg + t`` maps
    token ``t`` through expert ``e``) with ``occupancy`` of each segment
    valid; slack slots hold real tokens with nonzero weights when
    ``garbage`` is set, which both sides must ignore."""
    tok = np.tile(np.arange(Tg, dtype=np.int32), E)
    w = rng.uniform(0.1, 1.0, E * Tg).astype(np.float32)
    nv = int(round(Tg * occupancy))
    valid = np.full(E, nv, np.int32)
    valid[1] = Tg if occupancy > 0 else 0     # one full, if any is live
    for e in range(E):
        lo, hi = e * Tg + valid[e], (e + 1) * Tg
        if garbage:
            tok[lo:hi] = rng.integers(0, Tg, hi - lo)
        else:
            tok[lo:hi], w[lo:hi] = Tg, 0.0
    w[rng.random(E * Tg) < 0.3] = 0.0          # tokens that skip an expert
    return tok, w, valid


def weights(rng, E, d, f):
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in ((E, d, f), (E, d, f), (E, f, d))]


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("occupancy", [0.0, 0.5, 1.0])
def test_local_moe_matches_jax(occupancy, activation):
    rng = np.random.default_rng(0)
    Tg, E, d, f = 8, 4, 64, 128
    x = rng.standard_normal((Tg, d)).astype(np.float32)
    tok, w, valid = gather_layout(rng, Tg, E, occupancy)
    wi, wg, wo = weights(rng, E, d, f)
    offs = transport.expert_segments(E, Tg)
    exps = tuple(range(E))
    wg = wg if activation == "swiglu" else None
    got = fused_ops.local_moe(
        torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(w),
        offs, exps, torch.from_numpy(valid), torch.from_numpy(wi),
        None if wg is None else torch.from_numpy(wg), torch.from_numpy(wo),
        activation=activation)
    jargs = (jnp.asarray(x), jnp.asarray(tok), jnp.asarray(w), offs, exps,
             jnp.asarray(valid), jnp.asarray(wi),
             None if wg is None else jnp.asarray(wg), jnp.asarray(wo))
    close(got, jlocal_moe_ref(*jargs, activation=activation))
    close(got, jfused_ops.local_moe(*jargs, activation=activation,
                                    use_pallas=True))
    if occupancy == 0.0:
        assert not np.asarray(got).any()


def test_local_moe_prefill_layout_sentinel_slots():
    """A ragged prefill-like layout (unequal segments, sentinel slots)."""
    rng = np.random.default_rng(1)
    T, E, d, f = 12, 3, 64, 64
    offs = (0, 16, 24, 40)
    exps = (2, 0, 1)
    S = offs[-1]
    tok = rng.integers(0, T + 1, S).astype(np.int32)      # T = sentinel
    w = np.where(tok == T, 0.0, rng.uniform(0.1, 1.0, S)).astype(np.float32)
    valid = np.asarray([16, 5, 0], np.int32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    wi, _, wo = weights(rng, E, d, f)
    got = fused_ops.local_moe(
        torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(w),
        offs, exps, torch.from_numpy(valid), torch.from_numpy(wi), None,
        torch.from_numpy(wo), activation="gelu")
    want = jlocal_moe_ref(jnp.asarray(x), jnp.asarray(tok), jnp.asarray(w),
                          offs, exps, jnp.asarray(valid), jnp.asarray(wi),
                          None, jnp.asarray(wo), activation="gelu")
    close(got, want)


@pytest.mark.parametrize("offs,exps", [((0, 8, 16, 24, 32), (0, 1, 2, 3)),
                                       ((0, 100, 230, 236), (1, 0, 1)),
                                       ((0, 512, 1024), (0, 1))])
def test_block_planning(offs, exps):
    """plan_blocks is the reference's; plan_tiles (the CUDA kernel's fixed
    64-row tiling) covers every slot exactly once, inside one segment."""
    for got, want in zip(gemm_ops.plan_blocks(offs, exps),
                         jgemm_ops.plan_blocks(offs, exps)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    tiles = fused_ops.plan_tiles(offs, exps)
    seen = np.zeros(offs[-1], np.int32)
    for first, e, s, loc, rows in tiles:
        assert 0 < rows <= fused_ops.TILE_ROWS and e == exps[s]
        assert offs[s] + loc == first and loc + rows <= offs[s + 1] - offs[s]
        seen[first:first + rows] += 1
    assert (seen == 1).all()


def test_permute_refs_match_jax():
    from repro.kernels.moe_permute import ref as jref
    rng = np.random.default_rng(2)
    T, S, K, d = 10, 14, 2, 16
    x = rng.standard_normal((T, d)).astype(np.float32)
    tok = rng.integers(0, T + 1, S).astype(np.int32)
    y = rng.standard_normal((S, d)).astype(np.float32)
    inv_idx = rng.integers(0, S + 1, (T, K)).astype(np.int32)
    inv_w = rng.uniform(0, 1, (T, K)).astype(np.float32)
    close(permute_ref.permute_ref(torch.from_numpy(x), torch.from_numpy(tok)),
          jref.permute_ref(jnp.asarray(x), jnp.asarray(tok)))
    close(permute_ref.unpermute_ref(torch.from_numpy(y),
                                    torch.from_numpy(inv_idx),
                                    torch.from_numpy(inv_w)),
          jref.unpermute_ref(jnp.asarray(y), jnp.asarray(inv_idx),
                             jnp.asarray(inv_w)))


@pytest.mark.parametrize("B,Sq,H,K,hd,causal,window", [
    (2, 64, 4, 2, 32, True, 0),        # causal GQA
    (1, 72, 4, 4, 64, True, 24),       # windowed; 72 is not a block multiple
    (1, 40, 2, 1, 32, False, 0),       # bidirectional
])
def test_flash_attention_matches_jax(B, Sq, H, K, hd, causal, window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 sliding_window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = flash_attention_pallas(jq, jk, jv, causal=causal,
                                  sliding_window=window, block_q=32,
                                  block_k=32, interpret=True)
    pos = jnp.arange(Sq)
    sdpa = jlayers._sdpa(jq, jk, jv, causal=causal, sliding_window=window,
                         q_positions=pos, k_positions=pos)
    close(got, kern)
    close(got, sdpa)


def test_cpu_tensors_take_the_plain_versions():
    """Even with kernels forced on, CPU tensors run the plain versions and
    no kernel launch is counted."""
    backend.reset_launches()
    x = torch.randn(4, 64)
    out = fused_ops.local_moe(
        x, torch.arange(8, dtype=torch.int32) % 4, torch.ones(8),
        (0, 4, 8), (0, 1), None, torch.randn(2, 64, 64), None,
        torch.randn(2, 64, 64), activation="gelu", use_pallas=True)
    q = torch.randn(1, 8, 2, 32)
    fa_ops.flash_attention(q, q, q, use_pallas=True)
    assert out.shape == (4, 64) and out.dtype == torch.float32
    assert all(n == 0 for n in backend.LAUNCHES.values())
