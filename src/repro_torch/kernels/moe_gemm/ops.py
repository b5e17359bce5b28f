"""Grouped-FFN entries with the backend policy and autograd (the counterpart
of ``repro/kernels/moe_gemm/ops.py``, non-quantized branches).

* :func:`grouped_ffn_ragged` — the occupancy-aware entry over a flat
  [R, d] buffer of static contiguous segments with runtime per-segment
  valid-row counts.  For CUDA tensors (with kernels wanted) it launches K3
  of ``csrc/moe_gemm.cu`` inside a ``torch.autograd.Function`` whose
  backward is autograd through :func:`ref.grouped_ffn_ragged_ref`, as the
  reference's ``_ragged_bwd`` is ``jax.vjp`` of it; CPU tensors take the
  plain version.
* :func:`grouped_ffn_segments` — the segment-offset surface the dispatch
  engine calls: equal fully-occupied per-expert spans reshape onto the
  dense plain grouped FFN when the kernels are off; everything else goes
  through :func:`grouped_ffn_ragged`.
* :func:`plan_blocks` — the reference's gcd-divisor block decomposition,
  kept so the port can state the reference's block layout; the CUDA
  kernels tile with fixed 64-row tiles instead (``moe_fused.ops.plan_tiles``)
  because the gcd rule gives 8-row blocks for the 2x2 plan's widths.

The dense Pallas kernel (K6, ``MoEConfig.use_kernel``) and the int8 ragged
kernel (K7, the ``int8`` wire codec) are not ported yet: asking for either
raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.moe_fused.ops import TILE_ROWS, tiles_on
from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_ref,
                                              grouped_ffn_ref)

KERNEL = "moe_gemm.grouped_ffn_ragged"
_V, _I = ctypes.c_void_p, ctypes.c_int


def use_ragged(use_pallas=None, device="cuda") -> bool:
    """Whether the engine takes the occupancy-aware branch (the count
    exchange and the ragged entry): the shared ``backend.want_kernels``
    decision, as in the reference (on the CPU a forced branch runs the
    plain version)."""
    return backend.want_kernels(use_pallas, device)


def plan_blocks(seg_offsets, seg_experts, block_c: int = 128):
    """Static block decomposition of a segment layout: the largest row
    block ``bc <= block_c`` dividing every segment width.  Returns
    ``(bc, block_row, block_eid, block_seg, block_loc)`` numpy vectors:
    block ``b`` covers flat rows ``block_row[b]*bc : +bc``, multiplies
    expert ``block_eid[b]``, and starts ``block_loc[b]`` rows into segment
    ``block_seg[b]``."""
    offs = tuple(int(o) for o in seg_offsets)
    widths = [offs[s + 1] - offs[s] for s in range(len(offs) - 1)]
    g = 0
    for w in widths:
        g = math.gcd(g, w)
    bc = 1
    for cand in range(min(g, int(block_c)), 0, -1):
        if g % cand == 0:
            bc = cand
            break
    rows, eids, segs, locs = [], [], [], []
    for s, (e, w) in enumerate(zip(seg_experts, widths)):
        for i in range(w // bc):
            rows.append(offs[s] // bc + i)
            eids.append(int(e))
            segs.append(s)
            locs.append(i * bc)
    return (bc, np.asarray(rows, np.int32), np.asarray(eids, np.int32),
            np.asarray(segs, np.int32), np.asarray(locs, np.int32))


@functools.lru_cache(maxsize=1)
def _entry():
    lib = backend.load("moe_gemm")
    rows = lib.moe_gemm_tile_rows
    rows.argtypes, rows.restype = [], ctypes.c_int
    if rows() != TILE_ROWS:
        raise RuntimeError(f"moe_gemm.cu tiles {rows()} rows, the wrapper "
                           f"plans {TILE_ROWS}")
    return backend.bind("moe_gemm", "grouped_ffn_ragged",
                        [_V, _I, _I, _V, _V, _I, _V, _V, _V, _V, _V, _I, _V])


def _check(name, t, dtype, device, ndim, vectors=True):
    """``vectors``: the kernel reads ``t`` through 16-byte vectors."""
    if t.device != device:
        raise ValueError(f"{KERNEL}: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{KERNEL}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous() or (
            vectors and t.data_ptr() % 16):
        raise ValueError(f"{KERNEL}: {name} must be a contiguous"
                         f"{', 16-byte aligned' if vectors else ''} {ndim}-D "
                         f"tensor, got {tuple(t.shape)}")


def _ragged_cuda(static, x, rows_valid, w_in, w_gate, w_out):
    offs, exps, activation = static
    swiglu = activation == "swiglu"
    dev = x.device
    R, d = x.shape
    E, d_in, f = w_in.shape
    _check("x", x, torch.bfloat16, dev, 2)
    _check("rows_valid", rows_valid, torch.int32, dev, 1, vectors=False)
    _check("w_in", w_in, torch.bfloat16, dev, 3)
    _check("w_out", w_out, torch.bfloat16, dev, 3)
    if swiglu:
        _check("w_gate", w_gate, torch.bfloat16, dev, 3)
        if w_gate.shape != w_in.shape:
            raise ValueError(f"{KERNEL}: w_gate {tuple(w_gate.shape)} != "
                             f"w_in {tuple(w_in.shape)}")
    if d_in != d or tuple(w_out.shape) != (E, f, d):
        raise ValueError(f"{KERNEL}: weights {tuple(w_in.shape)} / "
                         f"{tuple(w_out.shape)} do not fit d={d}")
    if d % 64 or f % 64:
        raise ValueError(f"{KERNEL}: d={d} and f={f} must be multiples of 64")
    if rows_valid.shape[0] != len(exps) or max(exps) >= E or min(exps) < 0:
        raise ValueError(f"{KERNEL}: rows_valid / seg_experts do not fit "
                         f"{E} experts")
    tiles = tiles_on(offs, exps, str(dev))
    n_tiles = tiles.shape[0]
    h = torch.empty((n_tiles * TILE_ROWS, f), dtype=torch.bfloat16,
                    device=dev)
    y = torch.empty((R, d), dtype=torch.bfloat16, device=dev)
    err = _entry()(backend.ptr(x), d, f, backend.ptr(rows_valid),
                   backend.ptr(tiles), n_tiles, backend.ptr(w_in),
                   backend.ptr(w_gate if swiglu else None),
                   backend.ptr(w_out), backend.ptr(h), backend.ptr(y),
                   int(swiglu), backend.stream_ptr(dev))
    backend.check(KERNEL, err)
    backend.record_launch(KERNEL)
    return y


class GroupedFFNRagged(torch.autograd.Function):
    """``impl(static, x, rows_valid, w_in, w_gate, w_out)`` forward (the
    CUDA kernel, or the plain version when a test drives the backward on
    the CPU); backward: autograd through ``grouped_ffn_ragged_ref``.
    ``static`` is ``(seg_offsets, seg_experts, activation)``."""

    @staticmethod
    def forward(ctx, x, rows_valid, w_in, w_gate, w_out, static, impl):
        ctx.static = static
        ctx.save_for_backward(x, rows_valid, w_in, w_gate, w_out)
        return impl(static, x, rows_valid, w_in, w_gate, w_out)

    @staticmethod
    def backward(ctx, g):
        offs, exps, activation = ctx.static
        x, rows_valid, w_in, w_gate, w_out = ctx.saved_tensors
        wg_in = w_gate if activation == "swiglu" else None
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip((x, w_in, wg_in, w_out),
                                     (ctx.needs_input_grad[0],
                                      ctx.needs_input_grad[2],
                                      ctx.needs_input_grad[3],
                                      ctx.needs_input_grad[4]))]
        with torch.enable_grad():
            y = grouped_ffn_ragged_ref(inputs[0], offs, exps, rows_valid,
                                       inputs[1], inputs[2], inputs[3],
                                       activation=activation)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype))
                         if wanted else ())
        gx, gwi, gwg, gwo = (next(grads) if t is not None and t.requires_grad
                             else None for t in inputs)
        return gx, None, gwi, gwg, gwo, None, None


def grouped_ffn_ragged(x, seg_offsets, seg_experts, rows_valid, w_in, w_gate,
                       w_out, *, activation: str = "swiglu", use_pallas=None):
    """Occupancy-aware grouped FFN over a flat [R, d] segment-sorted buffer.

    ``seg_offsets`` (static [S + 1]) and ``seg_experts`` (static [S]) give
    each contiguous segment's rows and expert; ``rows_valid`` (runtime [S]
    int32, or None = fully occupied) its realized row count.  Rows at or
    past the count come back as exact zeros.  Returns [R, d] in x's dtype.
    """
    offs = tuple(int(o) for o in seg_offsets)
    exps = tuple(int(e) for e in seg_experts)
    R = x.shape[0]
    if not (len(offs) == len(exps) + 1 and offs[0] == 0 and offs[-1] == R):
        raise ValueError(f"bad segment layout {offs} for {len(exps)} "
                         f"segments and {R} rows")
    if R == 0:
        return x
    swiglu = activation == "swiglu" and w_gate is not None
    if rows_valid is None:
        rows_valid = torch.as_tensor(
            [offs[s + 1] - offs[s] for s in range(len(exps))],
            dtype=torch.int32, device=x.device)
    if not backend.kernels_active(use_pallas, x.device):
        return grouped_ffn_ragged_ref(x, offs, exps, rows_valid, w_in,
                                      w_gate if swiglu else None, w_out,
                                      activation=activation)
    static = (offs, exps, "swiglu" if swiglu else "gelu")
    return GroupedFFNRagged.apply(x, rows_valid, w_in,
                                  w_gate if swiglu else None, w_out, static,
                                  _ragged_cuda)


def grouped_ffn_segments(x, seg_offsets, w_in, w_gate, w_out, *,
                         activation: str = "swiglu", seg_experts=None,
                         rows_valid=None, use_pallas=None,
                         quantized: bool = False):
    """Segment-offset grouped FFN over a flat [R, d] row buffer: segment
    ``s`` owns rows ``seg_offsets[s]:seg_offsets[s + 1]`` and multiplies
    expert ``seg_experts[s]`` (default: one segment per expert, in order).
    Equal fully-occupied per-expert spans with the kernels off reshape
    onto the dense plain grouped FFN; every other call goes through
    :func:`grouped_ffn_ragged`."""
    if quantized:
        raise NotImplementedError(
            "quantized expert compute needs the int8 ragged grouped FFN "
            "kernel (K7, moe_gemm/kernel.py:312), not ported yet")
    offs = tuple(int(o) for o in seg_offsets)
    E = w_in.shape[0]
    if seg_experts is None:
        if len(offs) != E + 1:
            raise ValueError(f"{len(offs) - 1} segments for {E} experts")
        seg_experts = tuple(range(E))
    if not (offs[0] == 0 and offs[-1] == x.shape[0]):
        raise ValueError(f"bad segment layout {offs} for {x.shape[0]} rows")
    widths = [offs[s + 1] - offs[s] for s in range(len(seg_experts))]
    d = x.shape[-1]
    dense = (rows_valid is None and len(set(widths)) == 1
             and len(widths) == E
             and tuple(seg_experts) == tuple(range(E))
             and not use_ragged(use_pallas, x.device))
    if dense:
        y = grouped_ffn_ref(x.reshape(E, widths[0], d), w_in, w_gate, w_out,
                            activation=activation)
        return y.reshape(-1, d)
    return grouped_ffn_ragged(x, offs, seg_experts, rows_valid, w_in, w_gate,
                              w_out, activation=activation,
                              use_pallas=use_pallas)
