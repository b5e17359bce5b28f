"""Public flash-attention entry with the backend policy (the counterpart of
``repro/kernels/flash_attn/ops.py``).

For CUDA tensors (with kernels wanted) :func:`flash_attention` launches
the hand-written kernel of ``csrc/flash_attn.cu``; for CPU tensors it
runs the plain :func:`ref.flash_attention_ref`.  Forward only in this
slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

KERNEL = "flash_attn.flash_attention"
#: the only variant the kernel builds: gpt3_medium_moe's serving path
HEAD_DIM, DTYPE = 64, torch.bfloat16
_V, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=1)
def _entry():
    return backend.bind("flash_attn", "flash_attention_fwd",
                        [_V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I, _I, _V])


def _flash_cuda(q, k, v, causal: bool, sliding_window: int):
    backend.check_no_grad(KERNEL, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{KERNEL}: q, k, v must be 4-D [B, S, heads, hd]")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, K, hd) or v.shape != k.shape:
        raise ValueError(f"{KERNEL}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if K == 0 or H % K:
        raise ValueError(f"{KERNEL}: {H} query heads over {K} kv heads")
    if hd != HEAD_DIM:
        raise ValueError(f"{KERNEL}: head_dim {hd}; the kernel is built "
                         f"for {HEAD_DIM} only")
    if (q.dtype, k.dtype, v.dtype) != (DTYPE,) * 3:
        raise TypeError(f"{KERNEL}: q/k/v must be {DTYPE}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{KERNEL}: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = _entry()(backend.ptr(q), backend.ptr(k), backend.ptr(v),
                   backend.ptr(o), B, Sq, Sk, H, K, hd, int(bool(causal)),
                   int(sliding_window), backend.stream_ptr(q.device))
    backend.check(KERNEL, err)
    backend.record_launch(KERNEL)
    return o


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    use_pallas=None):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, K, hd] -> [B, Sq, H, hd] in q's
    dtype.  The CUDA kernel takes bfloat16 with hd = 64 and raises on
    anything else; the plain version (CPU tensors) takes any."""
    if not backend.kernels_active(use_pallas, q.device):
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    return _flash_cuda(q, k, v, causal, sliding_window)
