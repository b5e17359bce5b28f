"""Grouped-FFN entries with the backend policy and autograd (the counterpart
of ``repro/kernels/moe_gemm/ops.py``).

* :func:`grouped_ffn` — the dense equal-capacity [E, C, d] grouped FFN
  (``MoEConfig.use_kernel``).  It decides by the shared policy alone (any
  ``use_pallas`` of the caller is not read, as in the reference): for
  CUDA tensors it launches K6 of ``csrc/moe_gemm.cu`` inside a
  ``torch.autograd.Function`` whose backward is autograd through
  :func:`ref.grouped_ffn_ref` (the reference's ``custom_vjp``); CPU
  tensors take the plain version.
  The reference's ``grouped_ffn_chunk`` (the capacity axis zero-padded to
  a multiple of ``row_align`` for its MXU blocks) has no counterpart: K6
  masks the rows of its last 64-row tile, so any C runs as it is, and
  zero rows give the same numbers; the reference calls it only behind
  ``expert_ffn(chunk_granular=)``, which the port lacks for that reason
  too (``core/dispatch/engine.py``).
* :func:`grouped_ffn_ragged` — the occupancy-aware entry over a flat
  [R, d] buffer of static contiguous segments with runtime per-segment
  valid-row counts.  For CUDA tensors (with kernels wanted) it launches K3
  of ``csrc/moe_gemm.cu`` inside a ``torch.autograd.Function`` whose
  backward is autograd through :func:`ref.grouped_ffn_ragged_ref`, as the
  reference's ``_ragged_bwd`` is ``jax.vjp`` of it; CPU tensors take the
  plain version.
* :func:`grouped_ffn_ragged_quant` — the int8 entry (K7, the ``int8``
  wire codec): per-segment int8 activations x per-expert int8 ``w_in``
  (and ``w_gate``), exact integer sums, f32 dequant, bf16 down-projection.
  Quantization is plain torch outside the kernel, as in the reference.
  The forward launches K7 of ``csrc/moe_gemm.cu`` for CUDA tensors and
  runs :func:`ref.grouped_ffn_ragged_quant_ref` for CPU tensors; either
  way inside the Function whose backward is autograd through the
  full-precision ``grouped_ffn_ragged_ref`` (straight-through).
* :func:`grouped_ffn_segments` — the segment-offset surface the dispatch
  engine calls: ``quantized=True`` goes to the int8 entry; equal
  fully-occupied per-expert spans reshape onto the dense plain grouped
  FFN when the kernels are off; everything else goes through
  :func:`grouped_ffn_ragged`.
* :func:`plan_blocks` — the reference's gcd-divisor block decomposition,
  kept so the port can state the reference's block layout; the CUDA
  kernels tile with fixed 64-row tiles instead (``moe_fused.ops.plan_tiles``)
  because the gcd rule gives 8-row blocks for the 2x2 plan's widths.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.moe_fused.ops import TILE_ROWS, tiles_on
from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                              grouped_ffn_ragged_ref,
                                              grouped_ffn_ref,
                                              quantize_experts,
                                              quantize_segments)

KERNEL = "moe_gemm.grouped_ffn_ragged"
KERNEL_DENSE = "moe_gemm.grouped_ffn"
KERNEL_QUANT = "moe_gemm.grouped_ffn_ragged_quant"
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


@functools.lru_cache(maxsize=1)
def _quant_entry():
    _entry()                                 # loads and checks the tiling
    return backend.bind("moe_gemm", "grouped_ffn_ragged_quant",
                        [_V, _I, _I, _V, _V, _I, _V, _V, _V, _V, _V, _V, _V,
                         _I, _V])


@functools.lru_cache(maxsize=1)
def _dense_entry():
    return backend.bind("moe_gemm", "grouped_ffn_dense",
                        [_V, _I, _I, _I, _I, _V, _V, _V, _V, _V, _I, _V])


def _check(kernel, name, t, dtype, device, ndim, vectors=True):
    """``vectors``: the kernel reads ``t`` through 16-byte vectors."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous() or (
            vectors and t.data_ptr() % 16):
        raise ValueError(f"{kernel}: {name} must be a contiguous"
                         f"{', 16-byte aligned' if vectors else ''} {ndim}-D "
                         f"tensor, got {tuple(t.shape)}")


def _check_layout(kernel, static, x, rows_valid, w_in, w_gate, w_out):
    """The checks K3 and K7 share: device, dtypes, shapes and alignment of
    the bf16 inputs, and the segment table against the experts."""
    offs, exps, activation = static
    dev = x.device
    R, d = x.shape
    E, d_in, f = w_in.shape
    _check(kernel, "x", x, torch.bfloat16, dev, 2)
    _check(kernel, "rows_valid", rows_valid, torch.int32, dev, 1,
           vectors=False)
    _check(kernel, "w_in", w_in, torch.bfloat16, dev, 3)
    _check(kernel, "w_out", w_out, torch.bfloat16, dev, 3)
    if activation == "swiglu":
        _check(kernel, "w_gate", w_gate, torch.bfloat16, dev, 3)
        if w_gate.shape != w_in.shape:
            raise ValueError(f"{kernel}: w_gate {tuple(w_gate.shape)} != "
                             f"w_in {tuple(w_in.shape)}")
    if d_in != d or tuple(w_out.shape) != (E, f, d):
        raise ValueError(f"{kernel}: weights {tuple(w_in.shape)} / "
                         f"{tuple(w_out.shape)} do not fit d={d}")
    if d % 64 or f % 64:
        raise ValueError(f"{kernel}: d={d} and f={f} must be multiples of 64")
    if rows_valid.shape[0] != len(exps) or max(exps) >= E or min(exps) < 0:
        raise ValueError(f"{kernel}: rows_valid / seg_experts do not fit "
                         f"{E} experts")


def _dense_cuda(activation, x, w_in, w_gate, w_out):
    """K6: the checks, then the two launches over (expert, 64-row tile).
    ``x`` may be a strided view (the einsum dispatch's product is one)."""
    x = x.contiguous()
    dev = x.device
    E, C, d = x.shape
    f = w_in.shape[-1]
    swiglu = activation == "swiglu"
    _check(KERNEL_DENSE, "x", x, torch.bfloat16, dev, 3)
    _check(KERNEL_DENSE, "w_in", w_in, torch.bfloat16, dev, 3)
    _check(KERNEL_DENSE, "w_out", w_out, torch.bfloat16, dev, 3)
    if swiglu:
        _check(KERNEL_DENSE, "w_gate", w_gate, torch.bfloat16, dev, 3)
        if w_gate.shape != w_in.shape:
            raise ValueError(f"{KERNEL_DENSE}: w_gate {tuple(w_gate.shape)} "
                             f"!= w_in {tuple(w_in.shape)}")
    if tuple(w_in.shape) != (E, d, f) or tuple(w_out.shape) != (E, f, d):
        raise ValueError(f"{KERNEL_DENSE}: weights {tuple(w_in.shape)} / "
                         f"{tuple(w_out.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if d % 64 or f % 64:
        raise ValueError(f"{KERNEL_DENSE}: d={d} and f={f} must be "
                         f"multiples of 64")
    h = torch.empty((E, C, f), dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(x)
    err = _dense_entry()(backend.ptr(x), E, C, d, f, backend.ptr(w_in),
                         backend.ptr(w_gate if swiglu else None),
                         backend.ptr(w_out), backend.ptr(h), backend.ptr(y),
                         int(swiglu), backend.stream_ptr(dev))
    backend.check(KERNEL_DENSE, err)
    backend.record_launch(KERNEL_DENSE)
    return y


def _dense_plain(activation, x, w_in, w_gate, w_out):
    return grouped_ffn_ref(x, w_in, w_gate, w_out, activation=activation)


class GroupedFFN(torch.autograd.Function):
    """``impl(activation, x, w_in, w_gate, w_out)`` forward (K6, or the
    plain version); backward: autograd through ``grouped_ffn_ref``, so the
    forward kernel is not launched again."""

    @staticmethod
    def forward(ctx, x, w_in, w_gate, w_out, activation, impl):
        ctx.activation = activation
        ctx.save_for_backward(x, w_in, w_gate, w_out)
        return impl(activation, x, w_in, w_gate, w_out)

    @staticmethod
    def backward(ctx, g):
        x, w_in, w_gate, w_out = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip((x, w_in, w_gate, w_out),
                                     ctx.needs_input_grad[:4])]
        with torch.enable_grad():
            y = grouped_ffn_ref(*inputs, activation=ctx.activation)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype))
                         if wanted else ())
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in inputs) + (None, None)


def grouped_ffn(x, w_in, w_gate, w_out, *, activation: str = "swiglu"):
    """Dense grouped FFN: x [E, C, d]; w_in / w_gate [E, d, f]; w_out
    [E, f, d] -> [E, C, d] in x's dtype (the hidden activation rounded to
    it, f32 sums).  K6 for CUDA tensors with the kernels wanted (bf16
    only: anything else raises), the plain version otherwise; gelu when
    ``w_gate`` is None."""
    swiglu = activation == "swiglu" and w_gate is not None
    act = "swiglu" if swiglu else "gelu"
    w_gate = w_gate if swiglu else None
    impl = (_dense_cuda if backend.kernels_active(None, x.device)
            else _dense_plain)
    return GroupedFFN.apply(x, w_in, w_gate, w_out, act, impl)


def _ragged_cuda(static, x, rows_valid, w_in, w_gate, w_out):
    _check_layout(KERNEL, static, x, rows_valid, w_in, w_gate, w_out)
    offs, exps, activation = static
    swiglu = activation == "swiglu"
    dev = x.device
    (R, d), f = x.shape, w_in.shape[2]
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


def _ragged_quant_cuda(static, x, rows_valid, w_in, w_gate, w_out):
    """K7: quantize (plain torch, as the reference does outside its
    kernel), resolve one dequant factor per tile, launch."""
    _check_layout(KERNEL_QUANT, static, x, rows_valid, w_in, w_gate, w_out)
    offs, exps, activation = static
    swiglu = activation == "swiglu"
    dev = x.device
    (R, d), f = x.shape, w_in.shape[2]
    xq, sx = quantize_segments(x, offs)
    q_in, s_in = quantize_experts(w_in)
    tiles = tiles_on(offs, exps, str(dev))
    n_tiles = tiles.shape[0]
    t_seg, t_eid = tiles[:, 2].long(), tiles[:, 1].long()
    # per-tile dequant factors: segment scale x expert scale, in f32
    s1 = (sx[t_seg] * s_in[t_eid]).contiguous()
    q_g = sg = None
    if swiglu:
        q_g, s_g = quantize_experts(w_gate)
        sg = (sx[t_seg] * s_g[t_eid]).contiguous()
    h = torch.empty((n_tiles * TILE_ROWS, f), dtype=torch.bfloat16,
                    device=dev)
    y = torch.empty((R, d), dtype=torch.bfloat16, device=dev)
    err = _quant_entry()(backend.ptr(xq), d, f, backend.ptr(rows_valid),
                         backend.ptr(tiles), n_tiles, backend.ptr(s1),
                         backend.ptr(sg), backend.ptr(q_in),
                         backend.ptr(q_g), backend.ptr(w_out),
                         backend.ptr(h), backend.ptr(y), int(swiglu),
                         backend.stream_ptr(dev))
    backend.check(KERNEL_QUANT, err)
    backend.record_launch(KERNEL_QUANT)
    return y


def _ragged_quant_plain(static, x, rows_valid, w_in, w_gate, w_out):
    offs, exps, activation = static
    return grouped_ffn_ragged_quant_ref(x, offs, exps, rows_valid, w_in,
                                        w_gate, w_out, activation=activation)


class GroupedFFNRagged(torch.autograd.Function):
    """``impl(static, x, rows_valid, w_in, w_gate, w_out)`` forward (K3 or
    K7, or a plain version on the CPU); backward: autograd through the
    full-precision ``grouped_ffn_ragged_ref`` (for K7 the straight-through
    rule: round and clip are ignored).  ``static`` is ``(seg_offsets,
    seg_experts, activation)``."""

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
        with torch.enable_grad(), torch.profiler.record_function(
                "moe_gemm.grouped_ffn_ragged.backward"):
            y = grouped_ffn_ragged_ref(inputs[0], offs, exps, rows_valid,
                                       inputs[1], inputs[2], inputs[3],
                                       activation=activation)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype))
                         if wanted else ())
        gx, gwi, gwg, gwo = (next(grads) if t is not None and t.requires_grad
                             else None for t in inputs)
        return gx, None, gwi, gwg, gwo, None, None


def _static_args(x, seg_offsets, seg_experts, rows_valid, w_gate,
                 activation):
    """``(static, rows_valid)`` of a ragged call: the checked segment
    layout with the activation it runs (gelu without ``w_gate``), and the
    valid counts (every row when None)."""
    offs = tuple(int(o) for o in seg_offsets)
    exps = tuple(int(e) for e in seg_experts)
    R = x.shape[0]
    if not (len(offs) == len(exps) + 1 and offs[0] == 0 and offs[-1] == R):
        raise ValueError(f"bad segment layout {offs} for {len(exps)} "
                         f"segments and {R} rows")
    swiglu = activation == "swiglu" and w_gate is not None
    if rows_valid is None:
        rows_valid = torch.as_tensor(
            [offs[s + 1] - offs[s] for s in range(len(exps))],
            dtype=torch.int32, device=x.device)
    return (offs, exps, "swiglu" if swiglu else "gelu"), rows_valid


def grouped_ffn_ragged(x, seg_offsets, seg_experts, rows_valid, w_in, w_gate,
                       w_out, *, activation: str = "swiglu", use_pallas=None):
    """Occupancy-aware grouped FFN over a flat [R, d] segment-sorted buffer.

    ``seg_offsets`` (static [S + 1]) and ``seg_experts`` (static [S]) give
    each contiguous segment's rows and expert; ``rows_valid`` (runtime [S]
    int32, or None = fully occupied) its realized row count.  Rows at or
    past the count come back as exact zeros.  Returns [R, d] in x's dtype.
    """
    static, rows_valid = _static_args(x, seg_offsets, seg_experts,
                                      rows_valid, w_gate, activation)
    if x.shape[0] == 0:
        return x
    w_gate = w_gate if static[2] == "swiglu" else None
    if not backend.kernels_active(use_pallas, x.device):
        return grouped_ffn_ragged_ref(x, *static[:2], rows_valid, w_in,
                                      w_gate, w_out, activation=activation)
    return GroupedFFNRagged.apply(x, rows_valid, w_in, w_gate, w_out, static,
                                  _ragged_cuda)


def grouped_ffn_ragged_quant(x, seg_offsets, seg_experts, rows_valid, w_in,
                             w_gate, w_out, *, activation: str = "swiglu",
                             use_pallas=None):
    """The int8 ragged grouped FFN, same surface as
    :func:`grouped_ffn_ragged`: per-segment int8 activations x per-expert
    int8 up-projection weights with exact integer sums, dequantized before
    the activation; the down-projection in the model dtype with f32 sums.
    The backward is full precision (straight-through).  K7 for CUDA
    tensors with kernels wanted; the quantized plain version otherwise, so
    the arithmetic is the same on every device."""
    static, rows_valid = _static_args(x, seg_offsets, seg_experts,
                                      rows_valid, w_gate, activation)
    if x.shape[0] == 0:
        return x
    impl = (_ragged_quant_cuda
            if backend.kernels_active(use_pallas, x.device)
            else _ragged_quant_plain)
    return GroupedFFNRagged.apply(
        x, rows_valid, w_in, w_gate if static[2] == "swiglu" else None,
        w_out, static, impl)


def grouped_ffn_segments(x, seg_offsets, w_in, w_gate, w_out, *,
                         activation: str = "swiglu", seg_experts=None,
                         rows_valid=None, use_pallas=None,
                         quantized: bool = False):
    """Segment-offset grouped FFN over a flat [R, d] row buffer: segment
    ``s`` owns rows ``seg_offsets[s]:seg_offsets[s + 1]`` and multiplies
    expert ``seg_experts[s]`` (default: one segment per expert, in order).
    ``quantized`` sends every call to :func:`grouped_ffn_ragged_quant`;
    otherwise equal fully-occupied per-expert spans with the kernels off
    reshape onto the dense plain grouped FFN, and every other call goes
    through :func:`grouped_ffn_ragged`."""
    offs = tuple(int(o) for o in seg_offsets)
    E = w_in.shape[0]
    if seg_experts is None:
        if len(offs) != E + 1:
            raise ValueError(f"{len(offs) - 1} segments for {E} experts")
        seg_experts = tuple(range(E))
    if not (offs[0] == 0 and offs[-1] == x.shape[0]):
        raise ValueError(f"bad segment layout {offs} for {x.shape[0]} rows")
    if quantized:
        return grouped_ffn_ragged_quant(x, offs, seg_experts, rows_valid,
                                        w_in, w_gate, w_out,
                                        activation=activation,
                                        use_pallas=use_pallas)
    widths = [offs[s + 1] - offs[s] for s in range(len(seg_experts))]
    d = x.shape[-1]
    dense = (rows_valid is None and len(set(widths)) == 1
             and len(widths) == E
             and tuple(seg_experts) == tuple(range(E))
             and not use_ragged(use_pallas, x.device))
    if dense:
        y = grouped_ffn(x.reshape(E, widths[0], d), w_in, w_gate, w_out,
                        activation=activation)
        return y.reshape(-1, d)
    return grouped_ffn_ragged(x, offs, seg_experts, rows_valid, w_in, w_gate,
                              w_out, activation=activation,
                              use_pallas=use_pallas)
