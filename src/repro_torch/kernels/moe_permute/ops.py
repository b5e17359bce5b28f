"""Public permute/unpermute entries with the backend policy and autograd
(the counterpart of ``repro/kernels/moe_permute/ops.py``).

For CUDA tensors (with kernels wanted) :func:`permute` launches K1 and
:func:`unpermute` K2 of ``csrc/moe_permute.cu`` inside a
``torch.autograd.Function`` whose backward is the reference's
``custom_vjp`` backward written in torch: permute's is a scatter-add that
drops the sentinel (``ops.py:50-56`` there), unpermute's is K chunked
scatter-adds plus per-pick dot products for the gate weights (``:84-102``).
CPU tensors take the plain versions of ``ref.py``, differentiated by
autograd.  ``index_add_`` raises on an out-of-range index where JAX's
``mode="drop"`` drops it, so the scatters add into one spare row that is
sliced off.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.moe_permute.ref import (_with_zero_row, permute_ref,
                                                 unpermute_ref)

PERMUTE = "moe_permute.permute"
UNPERMUTE = "moe_permute.unpermute"
_V, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=1)
def _entries():
    return (backend.bind("moe_permute", "moe_permute",
                         [_V, _I, _I, _V, _I, _V, _V]),
            backend.bind("moe_permute", "moe_unpermute",
                         [_V, _I, _I, _I, _V, _V, _I, _I, _V, _V]))


def _check(kernel, name, t, dtypes, device, ndim):
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} must be one of {dtypes}, got "
                        f"{t.dtype}")
    if t.dim() != ndim or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be a contiguous, 16-byte "
                         f"aligned {ndim}-D tensor, got {tuple(t.shape)}")


def _permute_cuda(x, slot_to_token):
    dev = x.device
    _check(PERMUTE, "x", x, (torch.bfloat16, torch.float16, torch.float32),
           dev, 2)
    _check(PERMUTE, "slot_to_token", slot_to_token, (torch.int32,), dev, 1)
    T, d = x.shape
    row_bytes = d * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"{PERMUTE}: a row of {row_bytes} bytes is not a "
                         f"multiple of 16")
    S = slot_to_token.shape[0]
    out = torch.empty((S, d), dtype=x.dtype, device=dev)
    if S == 0:
        return out
    err = _entries()[0](backend.ptr(x), T, row_bytes,
                        backend.ptr(slot_to_token), S, backend.ptr(out),
                        backend.stream_ptr(dev))
    backend.check(PERMUTE, err)
    backend.record_launch(PERMUTE)
    return out


def _unpermute_cuda(y, inv_idx, inv_w):
    dev = y.device
    _check(UNPERMUTE, "y", y, (torch.bfloat16, torch.float32), dev, 2)
    _check(UNPERMUTE, "inv_idx", inv_idx, (torch.int32,), dev, 2)
    _check(UNPERMUTE, "inv_w", inv_w, (torch.float32,), dev, 2)
    S, d = y.shape
    T, K = inv_idx.shape
    if inv_w.shape != inv_idx.shape:
        raise ValueError(f"{UNPERMUTE}: inv_w {tuple(inv_w.shape)} != inv_idx "
                         f"{tuple(inv_idx.shape)}")
    bf16 = y.dtype == torch.bfloat16
    if d % (8 if bf16 else 4):
        raise ValueError(f"{UNPERMUTE}: d={d} is not a whole number of "
                         f"16-byte vectors")
    out = torch.empty((T, d), dtype=torch.float32, device=dev)
    if T == 0:
        return out
    err = _entries()[1](backend.ptr(y), S, d, int(bf16), backend.ptr(inv_idx),
                        backend.ptr(inv_w), T, K, backend.ptr(out),
                        backend.stream_ptr(dev))
    backend.check(UNPERMUTE, err)
    backend.record_launch(UNPERMUTE)
    return out


class Permute(torch.autograd.Function):
    """``impl(x, slot_to_token)`` forward (the CUDA kernel, or the plain
    version when a test drives the backward on the CPU); backward: the
    scatter-add of the cotangent rows, the sentinel slots dropped."""

    @staticmethod
    def forward(ctx, x, slot_to_token, impl):
        ctx.num_tokens = x.shape[0]
        ctx.save_for_backward(slot_to_token)
        return impl(x, slot_to_token)

    @staticmethod
    def backward(ctx, g):
        (slot_to_token,) = ctx.saved_tensors
        gx = g.new_zeros((ctx.num_tokens + 1, g.shape[-1]))
        gx.index_add_(0, slot_to_token.long(), g)
        return gx[:ctx.num_tokens], None, None


class Unpermute(torch.autograd.Function):
    """``impl(y, inv_idx, inv_w)`` forward; backward: per pick ``k`` one
    scatter-add of ``w * g`` into the slot rows and one dot product
    ``<g[t], y[inv_idx[t, k]]>`` for the gate weight (peak extra memory
    one [T, d] temporary per pick)."""

    @staticmethod
    def forward(ctx, y, inv_idx, inv_w, impl):
        ctx.save_for_backward(y, inv_idx, inv_w)
        return impl(y, inv_idx, inv_w)

    @staticmethod
    def backward(ctx, g):
        y, inv_idx, inv_w = ctx.saved_tensors
        S, d = y.shape
        g = g.to(torch.float32)
        y_z = _with_zero_row(y)
        gy = torch.zeros((S + 1, d), dtype=torch.float32, device=y.device)
        gw_cols = []
        for k in range(inv_idx.shape[1]):
            idx = inv_idx[:, k].long()
            gy.index_add_(0, idx, g * inv_w[:, k].to(torch.float32)[:, None])
            picked = y_z.index_select(0, idx).to(torch.float32)
            gw_cols.append(torch.sum(g * picked, dim=-1))
        gw = torch.stack(gw_cols, dim=1).to(inv_w.dtype)
        return gy[:S].to(y.dtype), None, gw, None


def permute(x, slot_to_token, *, use_pallas=None):
    """[T, d] tokens -> [S, d] sorted capacity-slot rows (see ref.py for
    the sentinel convention)."""
    if backend.kernels_active(use_pallas, x.device):
        return Permute.apply(x, slot_to_token, _permute_cuda)
    return permute_ref(x, slot_to_token)


def unpermute(y, inv_idx, inv_w, *, use_pallas=None):
    """[S, d] slot rows -> [T, d] float32 combined tokens, gate-weight
    multiply fused (see ref.py for the sentinel convention)."""
    if backend.kernels_active(use_pallas, y.device):
        return Unpermute.apply(y, inv_idx, inv_w, _unpermute_cuda)
    return unpermute_ref(y, inv_idx, inv_w)
