"""Decode attention (K8's entry), port against the JAX package on the CPU.

- ``decode_attn.ops.decode_attention`` against ``decode_attention_pallas(
  ..., interpret=True)`` and ``decode_attention_ref`` over
  ``tests/test_kernels.py``'s sweep: GQA, a sliding window, an L that is
  not a multiple of the block.
- NaN in every k/v row past a request's length: the port (as the Pallas
  kernel) reads none of it into a sum.
- ``lengths == 0``: the port's plain version returns what the JAX
  reference returns (the mean of the request's v rows); the CUDA kernel
  returns zeros, as the Pallas kernel does, and is held to that on the card
  (``chip_smoke.py``).
- The wrapper sends CPU tensors to the plain version under every kernel
  policy and refuses a call that needs a gradient only on the card.

Inputs are made by numpy from a seed; tolerance rtol = atol = 1e-4 in
float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attn.kernel import decode_attention_pallas
from repro.kernels.decode_attn.ref import decode_attention_ref as jref
from repro_torch.kernels import backend
from repro_torch.kernels.decode_attn import ops as dec_ops
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def inputs(seed, B, H, K, hd, L, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, K, hd)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, L + 1, B)
    return q, k, v, np.asarray(lens, np.int32)


def port(q, k, v, lens, window):
    return dec_ops.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, lens)),
        sliding_window=window).numpy()


@pytest.mark.parametrize("B,H,K,hd,L,bl", [
    (1, 4, 4, 16, 64, 32),
    (3, 8, 4, 32, 128, 32),
    (2, 16, 2, 16, 100, 64),      # ragged L vs block
])
@pytest.mark.parametrize("window", [0, 48])
def test_decode_attention_matches_pallas_and_ref(B, H, K, hd, L, bl,
                                                 window):
    q, k, v, lens = inputs(L + H, B, H, K, hd, L)
    got = port(q, k, v, lens, window)
    assert got.shape == (B, H, hd) and got.dtype == np.float32
    close(got, decode_attention_pallas(q, k, v, lens, sliding_window=window,
                                       block_l=bl, interpret=True))
    close(got, jref(q, k, v, lens, sliding_window=window))


@pytest.mark.parametrize("window", [0, 20])
def test_nan_rows_past_the_length_are_not_read(window):
    B, H, K, hd, L = 3, 8, 2, 16, 100
    q, k, v, lens = inputs(1, B, H, K, hd, L, lens=[1, 37, 100])
    finite = port(q, k, v, lens, window)
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = np.nan, np.nan
    got = port(q, k, v, lens, window)
    assert np.isfinite(got).all()
    close(got, finite)
    close(got, decode_attention_pallas(q, k, v, lens, sliding_window=window,
                                       block_l=32, interpret=True))


def test_zero_length_follows_the_reference():
    B, H, K, hd, L = 3, 4, 2, 16, 40
    q, k, v, lens = inputs(2, B, H, K, hd, L, lens=[0, 5, 40])
    got = port(q, k, v, lens, 0)
    close(got, jref(q, k, v, lens))
    # the reference's softmax over no valid row is uniform over all L rows
    want0 = v[0].mean(axis=0).repeat(H // K, axis=0)
    close(got[0], want0)
    assert np.abs(got[0]).max() > 0.1
    pallas = decode_attention_pallas(q, k, v, lens, block_l=16,
                                     interpret=True)
    assert np.abs(np.asarray(pallas)[0]).max() == 0.0
    close(got[1:], np.asarray(pallas)[1:])


@pytest.mark.parametrize("env", [None, "1", "0"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(backend.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(backend.ENV_VAR, env)
    q, k, v, lens = inputs(3, 2, 4, 2, 16, 24)
    qt = torch.from_numpy(q).requires_grad_(True)
    before = backend.LAUNCHES[dec_ops.KERNEL]
    out = dec_ops.decode_attention(qt, *(torch.from_numpy(a)
                                         for a in (k, v, lens)))
    assert backend.LAUNCHES[dec_ops.KERNEL] == before
    close(out.detach(), decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v, lens))))
    with pytest.raises(NotImplementedError, match="no backward"):
        backend.check_no_grad(dec_ops.KERNEL, qt)
