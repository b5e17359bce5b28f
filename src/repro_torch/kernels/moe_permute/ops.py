"""Public permute/unpermute entries with the backend policy and autograd
(the counterpart of ``repro/kernels/moe_permute/ops.py``).

For CUDA tensors (with kernels wanted) :func:`permute` launches K1 and
:func:`unpermute` K2 of ``csrc/moe_permute.cu`` inside a
``torch.autograd.Function`` whose backward is the reference's
``custom_vjp`` backward written in torch: permute's is a scatter-add that
drops the sentinel (``ops.py:50-56`` there), unpermute's is K chunked
scatter-adds plus per-pick dot products for the gate weights (``:84-102``).
CPU tensors take the plain versions of ``ref.py``, differentiated by
autograd.

``index_add_`` raises on an out-of-range index where JAX's ``mode="drop"``
drops it, so each sentinel slot (each token's dropped picks) adds into a
discard row of its own past the real rows, sliced off afterwards: no row
takes more than K adds, and nothing waits on the host.

The launch path is kept short, since at the pipelined path's chunk shapes
the call costs more than the kernel: the ``autograd.Function`` only where
a gradient can flow, one pass of checks (a failing call is then checked
again field by field for its message), pointers and the stream passed to
ctypes as plain ints.
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
_X_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_Y_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=1)
def _entries():
    return (backend.bind("moe_permute", "moe_permute",
                         [_V, _I, _I, _V, _I, _V, _V]),
            backend.bind("moe_permute", "moe_unpermute",
                         [_V, _I, _I, _I, _V, _V, _I, _I, _V, _V]))


def _refuse(kernel, device, *specs):
    """Raise for the first tensor the kernel does not take; ``specs`` are
    ``(name, tensor, dtypes, ndim, aligned)``."""
    for name, t, dtypes, ndim, aligned in specs:
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{kernel}: {name} must be one of {dtypes}, got "
                            f"{t.dtype}")
        if t.dim() != ndim or not t.is_contiguous() or (
                aligned and t.data_ptr() % 16):
            raise ValueError(f"{kernel}: {name} must be a contiguous"
                             f"{', 16-byte aligned' if aligned else ''} "
                             f"{ndim}-D tensor, got {tuple(t.shape)}")


def _permute_cuda(x, slot_to_token):
    dev = x.device
    launch = _entries()[0]
    if not (x.dtype in _X_DTYPES and slot_to_token.dtype == torch.int32
            and x.dim() == 2 and slot_to_token.dim() == 1
            and slot_to_token.device == dev and x.is_contiguous()
            and slot_to_token.is_contiguous() and not x.data_ptr() % 16):
        _refuse(PERMUTE, dev, ("x", x, _X_DTYPES, 2, True),
                ("slot_to_token", slot_to_token, (torch.int32,), 1, False))
    T, d = x.shape
    row_bytes = d * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"{PERMUTE}: a row of {row_bytes} bytes is not a "
                         f"multiple of 16")
    S = slot_to_token.shape[0]
    out = torch.empty((S, d), dtype=x.dtype, device=dev)
    if S == 0:
        return out
    err = launch(x.data_ptr(), T, row_bytes, slot_to_token.data_ptr(), S,
                 out.data_ptr(), backend.stream_ptr(dev))
    backend.check(PERMUTE, err)
    backend.record_launch(PERMUTE)
    return out


def _unpermute_cuda(y, inv_idx, inv_w):
    dev = y.device
    launch = _entries()[1]
    if not (y.dtype in _Y_DTYPES and inv_idx.dtype == torch.int32
            and inv_w.dtype == torch.float32 and y.dim() == 2
            and inv_idx.dim() == 2 and inv_idx.device == dev
            and inv_w.device == dev and y.is_contiguous()
            and inv_idx.is_contiguous() and inv_w.is_contiguous()
            and not y.data_ptr() % 16):
        _refuse(UNPERMUTE, dev, ("y", y, _Y_DTYPES, 2, True),
                ("inv_idx", inv_idx, (torch.int32,), 2, False),
                ("inv_w", inv_w, (torch.float32,), 2, False))
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
    err = launch(y.data_ptr(), S, d, bf16, inv_idx.data_ptr(),
                 inv_w.data_ptr(), T, K, out.data_ptr(),
                 backend.stream_ptr(dev))
    backend.check(UNPERMUTE, err)
    backend.record_launch(UNPERMUTE)
    return out


def _discard_rows(idx, n):
    """``idx`` ([m] or [m, K], in ``[0, n]``) with every sentinel ``n``
    sent to a row of its own past ``n``: ``n + i`` for row ``i`` of
    ``idx`` (so a row of ``idx`` shares its discard row between its K
    columns)."""
    pos = torch.arange(n, n + idx.shape[0], device=idx.device)
    return torch.where(idx < n, idx, pos.view(-1, *([1] * (idx.dim() - 1))))


class Permute(torch.autograd.Function):
    """``impl(x, slot_to_token)`` forward (the CUDA kernel, or the plain
    version when a test drives the backward on the CPU); backward: the
    scatter-add of the cotangent rows, each sentinel slot into a discard
    row of its own ([T + S, d], only the first T rows zeroed)."""

    @staticmethod
    def forward(ctx, x, slot_to_token, impl):
        ctx.num_tokens = x.shape[0]
        ctx.save_for_backward(slot_to_token)
        return impl(x, slot_to_token)

    @staticmethod
    def backward(ctx, g):
        (slot_to_token,) = ctx.saved_tensors
        T = ctx.num_tokens
        with torch.profiler.record_function(f"{PERMUTE}.backward"):
            gx = g.new_empty((T + g.shape[0], g.shape[-1]))
            gx[:T].zero_()
            gx.index_add_(0, _discard_rows(slot_to_token, T), g)
            return gx[:T], None, None


class Unpermute(torch.autograd.Function):
    """``impl(y, inv_idx, inv_w)`` forward; backward: per pick ``k`` one
    scatter-add of ``w * g`` into the slot rows, each dropped pick into a
    discard row of its token ([S + T, d] f32, at most K adds a row), and
    one dot product ``<g[t], y[inv_idx[t, k]]>`` for the gate weight (peak
    extra memory one [T, d] temporary per pick)."""

    @staticmethod
    def forward(ctx, y, inv_idx, inv_w, impl):
        ctx.save_for_backward(y, inv_idx, inv_w)
        return impl(y, inv_idx, inv_w)

    @staticmethod
    def backward(ctx, g):
        y, inv_idx, inv_w = ctx.saved_tensors
        S, d = y.shape
        with torch.profiler.record_function(f"{UNPERMUTE}.backward"):
            g = g.to(torch.float32)
            y_z = _with_zero_row(y)
            gy = torch.empty((S + g.shape[0], d), dtype=torch.float32,
                             device=y.device)
            gy[:S].zero_()
            rows = _discard_rows(inv_idx, S)
            gw_cols = []
            for k in range(inv_idx.shape[1]):
                gy.index_add_(0, rows[:, k],
                              g * inv_w[:, k].to(torch.float32)[:, None])
                picked = y_z.index_select(0, inv_idx[:, k]).to(torch.float32)
                gw_cols.append(torch.sum(g * picked, dim=-1))
            gw = torch.stack(gw_cols, dim=1).to(inv_w.dtype)
            return gy[:S].to(y.dtype), None, gw, None


def permute(x, slot_to_token, *, use_pallas=None):
    """[T, d] tokens -> [S, d] sorted capacity-slot rows (see ref.py for
    the sentinel convention)."""
    if backend.kernels_active(use_pallas, x.device):
        if torch.is_grad_enabled() and x.requires_grad:
            return Permute.apply(x, slot_to_token, _permute_cuda)
        return _permute_cuda(x, slot_to_token)
    return permute_ref(x, slot_to_token)


def unpermute(y, inv_idx, inv_w, *, use_pallas=None):
    """[S, d] slot rows -> [T, d] float32 combined tokens, gate-weight
    multiply fused (see ref.py for the sentinel convention)."""
    if backend.kernels_active(use_pallas, y.device):
        if torch.is_grad_enabled() and (y.requires_grad or inv_w.requires_grad):
            return Unpermute.apply(y, inv_idx, inv_w, _unpermute_cuda)
        return _unpermute_cuda(y, inv_idx, inv_w)
    return unpermute_ref(y, inv_idx, inv_w)


# ---------------------------------------------------------------------------
# launch layouts (backend.register_kernel; csrc/moe_permute.cu's geometry)
# ---------------------------------------------------------------------------

#: csrc/moe_permute.cu: K1 runs PERMUTE_WARPS slot rows a block of one warp
#: each, K2 UNPERMUTE_THREADS / 32 tokens a block; both launch bounds are
#: their block sizes
PERMUTE_ROWS, PERMUTE_THREADS = 2, 64
UNPERMUTE_TOKENS, UNPERMUTE_THREADS = 4, 128


def permute_launch(S: int) -> backend.LaunchDecl:
    """K1's launch over ``S`` slots (the entry makes none at S = 0)."""
    gx = -(-S // PERMUTE_ROWS)
    return backend.LaunchDecl(
        "permute_kernel", (gx, 1, 1), PERMUTE_THREADS, 0, 0, PERMUTE_THREADS,
        spans=(backend.Span("out", S,
                            *backend.blocks(gx, PERMUTE_ROWS, S)),),
        writes=(backend.Write("out", lambda x, y, z: (
            x * PERMUTE_ROWS, (x + 1) * PERMUTE_ROWS, 0)),))


def unpermute_launch(T: int, K: int, bf16: bool = True) -> backend.LaunchDecl:
    """K2's launch over ``T`` tokens of ``K`` picks."""
    gx = -(-T // UNPERMUTE_TOKENS)
    kt = 2 if K == 2 else 0
    return backend.LaunchDecl(
        f"unpermute_kernel<{'bf16' if bf16 else 'float'},{kt}>", (gx, 1, 1),
        UNPERMUTE_THREADS, 0, 0, UNPERMUTE_THREADS,
        spans=(backend.Span("out", T,
                            *backend.blocks(gx, UNPERMUTE_TOKENS, T)),),
        writes=(backend.Write("out", lambda x, y, z: (
            x * UNPERMUTE_TOKENS, (x + 1) * UNPERMUTE_TOKENS, 0)),))


def _staged_layouts():
    from repro_torch.kernels import layouts
    ep_tp, m = layouts.EP_TP_SIZES, layouts.TP_MODEL
    for label, lay in (("2x2", layouts.staged()),
                       ("2x2_pipelined_chunk0",
                        layouts.staged(num_chunks=8)),
                       ("2x2x2", layouts.staged((2, 2, 2))),
                       ("ep2_tp2", layouts.staged(ep_tp, model=m)),
                       ("ep2_tp2_pipelined_chunk0",
                        layouts.staged(ep_tp, num_chunks=8, model=m)),
                       ("dsv2 2x2", layouts.dsv2_staged()),
                       ("dsv2 2x2_pipelined_chunk0",
                        layouts.dsv2_staged(pipelined=True)),
                       ("dsv2_236b 2x2",
                        layouts.dsv2_staged(arch_id=layouts.DSV2_236B_ID)),
                       ("dsv2_236b 2x2_pipelined_chunk0",
                        layouts.dsv2_staged(True, layouts.DSV2_236B_ID))):
        yield label, lay


@backend.register_kernel(PERMUTE)
def _permute_layouts():
    return [backend.KernelLayout(
        f"{PERMUTE}[{label} S={lay.slots}]", (permute_launch(lay.slots),),
        meta={"geometry": ("moe_permute", "moe_permute_geometry",
                           (lay.slots,))})
        for label, lay in _staged_layouts()]


@backend.register_kernel(UNPERMUTE)
def _unpermute_layouts():
    return [backend.KernelLayout(
        f"{UNPERMUTE}[{label} T={lay.tokens}]",
        (unpermute_launch(lay.tokens, lay.top_k),),
        meta={"geometry": ("moe_permute", "moe_unpermute_geometry",
                           (lay.tokens, lay.top_k, 1))})
        for label, lay in _staged_layouts()]
