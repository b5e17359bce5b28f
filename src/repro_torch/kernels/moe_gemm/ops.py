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
  neither loads nor writes the rows past C, so any C runs as it is, and
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
  Quantization is plain torch outside the kernel, as in the reference:
  x per call, the weights by :func:`quantize_expert_weights`, which the
  dispatch engine runs once a layer forward and passes to every chunk's
  call (``qweights=``).  The forward launches K7 of
  ``csrc/moe_gemm.cu`` for CUDA tensors and
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
  kernels tile with fixed 64-row tiles instead (K3 and K7 by expert span,
  ``moe_fused.ops.plan_expert_tiles``) because the gcd rule gives 8-row
  blocks for the 2x2 plan's widths.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.moe_fused.ops import TILE_ROWS, expert_tiles_on
from repro_torch.kernels.moe_gemm import ref as gemm_ref
from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                              grouped_ffn_ragged_ref,
                                              grouped_ffn_ref,
                                              quantize_segments,
                                              segment_ids_on)

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
                        [_V, _I, _I, _V, _V, _V, _V, _I, _V, _V, _V, _V, _V,
                         _I, _V])


@functools.lru_cache(maxsize=1)
def _quant_entry():
    _entry()                                 # loads and checks the tiling
    return backend.bind("moe_gemm", "grouped_ffn_ragged_quant",
                        [_V, _I, _I, _V, _V, _V, _V, _I, _V, _V, _V, _V, _V,
                         _V, _V, _V, _I, _V])


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
    """K6: the checks, then the two launches over (expert, 128-row block,
    64 columns).  ``x`` may be a strided view (the einsum dispatch's
    product is one)."""
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
    """K3: the checks, then the two launches over expert-span tiles; each
    row's segment and count are read on the device."""
    _check_layout(KERNEL, static, x, rows_valid, w_in, w_gate, w_out)
    offs, exps, activation = static
    swiglu = activation == "swiglu"
    dev = x.device
    (R, d), f = x.shape, w_in.shape[2]
    tiles, seg_start = expert_tiles_on(offs, exps, str(dev))
    row_seg = segment_ids_on(offs, str(dev), torch.int32)
    n_tiles = tiles.shape[0]
    h = torch.empty((n_tiles * TILE_ROWS, f), dtype=torch.bfloat16,
                    device=dev)
    y = torch.empty((R, d), dtype=torch.bfloat16, device=dev)
    err = _entry()(backend.ptr(x), d, f, backend.ptr(row_seg),
                   backend.ptr(seg_start), backend.ptr(rows_valid),
                   backend.ptr(tiles), n_tiles, backend.ptr(w_in),
                   backend.ptr(w_gate if swiglu else None),
                   backend.ptr(w_out), backend.ptr(h), backend.ptr(y),
                   int(swiglu), backend.stream_ptr(dev))
    backend.check(KERNEL, err)
    backend.record_launch(KERNEL)
    return y


def quantize_expert_weights(w_in, w_gate=None):
    """A layer's expert weights in int8, once: ``(q_in, s_in, q_gate,
    s_gate)``, each ``q`` the :func:`ref.quantize_experts` of an [E, d, f]
    weight stored transposed, [E, f, d] (the reduction axis innermost, as
    K7's int8 tensor cores read it), each ``s`` its [E] f32 scales; the
    gate's None without ``w_gate``; under no_grad.  The dispatch engine
    calls it once a forward and hands the result to every chunk's
    :func:`grouped_ffn_ragged_quant` (``qweights=``): the same numbers as
    quantizing in each call, which the backward never reads
    (straight-through).  The reference quantizes inside its jitted step,
    where XLA can fold the repeats; the eager port hoists them by hand."""
    out = []
    with torch.no_grad(), torch.profiler.record_function(
            "moe_gemm.quantize_expert_weights"):
        for w in (w_in, w_gate):
            if w is None:
                out += [None, None]
                continue
            q, s = gemm_ref.quantize_experts(w)
            out += [q.transpose(1, 2).contiguous(), s]
    return tuple(out)


def _check_qweights(qweights, w_in, swiglu):
    q_in, s_in, q_g, s_g = qweights
    dev, (E, d, f) = w_in.device, w_in.shape
    pairs = [("q_in", q_in, "s_in", s_in)]
    if swiglu:
        pairs.append(("q_gate", q_g, "s_gate", s_g))
    for qn, q, sn, sc in pairs:
        if q is None or sc is None:
            raise ValueError(f"{KERNEL_QUANT}: qweights lack {qn} / {sn}")
        _check(KERNEL_QUANT, qn, q, torch.int8, dev, 3)
        _check(KERNEL_QUANT, sn, sc, torch.float32, dev, 1, vectors=False)
        if tuple(q.shape) != (E, f, d) or sc.shape[0] != E:
            raise ValueError(f"{KERNEL_QUANT}: {qn} {tuple(q.shape)} / {sn} "
                             f"{tuple(sc.shape)} do not fit w_in "
                             f"{tuple(w_in.shape)} transposed")


def _ragged_quant_cuda(static, x, rows_valid, w_in, w_gate, w_out,
                       qweights=None):
    """K7: quantize x per segment (plain torch, as the reference does
    outside its kernel) and the weights unless ``qweights`` holds them,
    then the two launches over expert-span tiles; each row's segment
    scale and count are read on the device."""
    _check_layout(KERNEL_QUANT, static, x, rows_valid, w_in, w_gate, w_out)
    offs, exps, activation = static
    swiglu = activation == "swiglu"
    dev = x.device
    (R, d), f = x.shape, w_in.shape[2]
    if qweights is None:
        qweights = quantize_expert_weights(w_in, w_gate if swiglu else None)
    _check_qweights(qweights, w_in, swiglu)
    q_in, s_in, q_g, s_g = qweights
    with torch.profiler.record_function(f"{KERNEL_QUANT}.forward"):
        xq, sx = quantize_segments(x, offs)
        tiles, seg_start = expert_tiles_on(offs, exps, str(dev))
        row_seg = segment_ids_on(offs, str(dev), torch.int32)
        n_tiles = tiles.shape[0]
        h = torch.empty((n_tiles * TILE_ROWS, f), dtype=torch.bfloat16,
                        device=dev)
        y = torch.empty((R, d), dtype=torch.bfloat16, device=dev)
        err = _quant_entry()(backend.ptr(xq), d, f, backend.ptr(row_seg),
                             backend.ptr(seg_start), backend.ptr(rows_valid),
                             backend.ptr(tiles), n_tiles, backend.ptr(sx),
                             backend.ptr(s_in),
                             backend.ptr(s_g if swiglu else None),
                             backend.ptr(q_in),
                             backend.ptr(q_g if swiglu else None),
                             backend.ptr(w_out), backend.ptr(h),
                             backend.ptr(y), int(swiglu),
                             backend.stream_ptr(dev))
    backend.check(KERNEL_QUANT, err)
    backend.record_launch(KERNEL_QUANT)
    return y


def _ragged_quant_plain(static, x, rows_valid, w_in, w_gate, w_out,
                        qweights=None):
    offs, exps, activation = static
    return grouped_ffn_ragged_quant_ref(x, offs, exps, rows_valid, w_in,
                                        w_gate, w_out, activation=activation,
                                        qweights=qweights)


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
                             use_pallas=None, qweights=None):
    """The int8 ragged grouped FFN, same surface as
    :func:`grouped_ffn_ragged`: per-segment int8 activations x per-expert
    int8 up-projection weights with exact integer sums, dequantized before
    the activation; the down-projection in the model dtype with f32 sums.
    The backward is full precision (straight-through).  K7 for CUDA
    tensors with kernels wanted; the quantized plain version otherwise, so
    the arithmetic is the same on every device.  ``qweights``: the weights
    already quantized by :func:`quantize_expert_weights` (None: quantized
    in this call)."""
    static, rows_valid = _static_args(x, seg_offsets, seg_experts,
                                      rows_valid, w_gate, activation)
    if x.shape[0] == 0:
        return x
    impl = (_ragged_quant_cuda
            if backend.kernels_active(use_pallas, x.device)
            else _ragged_quant_plain)
    if qweights is not None:
        impl = functools.partial(impl, qweights=qweights)
    return GroupedFFNRagged.apply(
        x, rows_valid, w_in, w_gate if static[2] == "swiglu" else None,
        w_out, static, impl)


def grouped_ffn_segments(x, seg_offsets, w_in, w_gate, w_out, *,
                         activation: str = "swiglu", seg_experts=None,
                         rows_valid=None, use_pallas=None,
                         quantized: bool = False, qweights=None):
    """Segment-offset grouped FFN over a flat [R, d] row buffer: segment
    ``s`` owns rows ``seg_offsets[s]:seg_offsets[s + 1]`` and multiplies
    expert ``seg_experts[s]`` (default: one segment per expert, in order).
    ``quantized`` sends every call to :func:`grouped_ffn_ragged_quant`
    (with the pre-quantized ``qweights``, if given); otherwise equal
    fully-occupied per-expert spans with the kernels off reshape onto the
    dense plain grouped FFN, and every other call goes through
    :func:`grouped_ffn_ragged`."""
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
                                        use_pallas=use_pallas,
                                        qweights=qweights)
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


# ---------------------------------------------------------------------------
# launch layouts (backend.register_kernel; csrc/moe_gemm.cu's geometry)
# ---------------------------------------------------------------------------

#: csrc/moe_gemm.cu and moe_mma.cuh: 128 threads a block (every launch's
#: bound), 8 KB bf16 stage tiles; the span up launch in a ring of 2, the
#: span down launch in 4 stages of [64, 72] + [64, 72] bf16; K6 two tiles a
#: stage (128 rows a block) in a ring of 2; K7's up launch holds its int8
#: ring of 4 (gelu) or 3 (swiglu) stages of [64, 64] tiles statically.
#: Static arrays: span up a_row[64] + masks[2]; span down valid[64]; K6
#: a_row[128]; K7 up ring + valid[64] + f1[64] (+ fg[64] with swiglu;
#: gelu's fg[1] is never read and takes no space)
THREADS, STAGE_TILE, K6_ROWS = 128, 64 * 64 * 2, 128
SPAN_UP_SMEM = {False: 2 * 2 * STAGE_TILE, True: 2 * 3 * STAGE_TILE}
SPAN_DOWN_SMEM = 4 * (64 * 72 * 2 + 64 * 72 * 2)
SPAN_UP_STATIC = backend.static_smem(4 * 64 + 4 * 2)
SPAN_DOWN_STATIC = backend.static_smem(4 * 64)
QUANT_UP_STATIC = {False: backend.static_smem(4 * 2 * 64 * 64 + 4 * 64 * 2),
                   True: backend.static_smem(3 * 3 * 64 * 64 + 4 * 64 * 3)}
K6_UP_SMEM = {False: 2 * 3 * STAGE_TILE, True: 2 * 4 * STAGE_TILE}
K6_DOWN_SMEM, K6_STATIC = 2 * 3 * STAGE_TILE, backend.static_smem(4 * K6_ROWS)


def span_launches(seg_offsets: tuple, seg_experts: tuple, d: int, f: int,
                  swiglu: bool = False, quant: bool = False) -> tuple:
    """K3's (or with ``quant`` K7's) two launches over the wrapper's own
    expert-span tiles (``moe_fused.ops.plan_expert_tiles``): up over
    (tile, f / 64), down over (tile, d / 64)."""
    from repro_torch.kernels.moe_fused.ops import plan_expert_tiles
    tiles = plan_expert_tiles(seg_offsets, seg_experts)
    n_tiles, R = tiles.shape[0], seg_offsets[-1]
    spans = (backend.Span("x", R, tuple(int(r) for r in tiles[:, 0]),
                          tuple(int(r) for r in tiles[:, 2])),
             backend.Span("experts", max(seg_experts) + 1,
                          tuple(int(e) for e in tiles[:, 1]),
                          (1,) * n_tiles),
             backend.Span("h", n_tiles * TILE_ROWS,
                          *backend.blocks(n_tiles, TILE_ROWS,
                                          n_tiles * TILE_ROWS)))
    sw = str(swiglu).lower()
    if quant:
        up = backend.LaunchDecl(
            f"quant_span_up_kernel<{sw}>", (n_tiles, f // 64, 1), THREADS,
            0, QUANT_UP_STATIC[swiglu], THREADS, spans=spans)
    else:
        up = backend.LaunchDecl(
            f"span_up_kernel<{sw}>", (n_tiles, f // 64, 1), THREADS,
            SPAN_UP_SMEM[swiglu], SPAN_UP_STATIC, THREADS, spans=spans)
    up = dataclasses.replace(up, writes=(backend.Write(
        "h", lambda x, y, z: (x * TILE_ROWS, (x + 1) * TILE_ROWS, y)),))
    down = backend.LaunchDecl(
        "span_down_kernel", (n_tiles, d // 64, 1), THREADS, SPAN_DOWN_SMEM,
        SPAN_DOWN_STATIC, THREADS, spans=spans,
        writes=(backend.Write("y", lambda x, y, z: (
            int(tiles[x, 0]), int(tiles[x, 0] + tiles[x, 2]), y)),))
    return up, down


def span_layout(name: str, label: str, seg_offsets: tuple,
                seg_experts: tuple, d: int, f: int, swiglu: bool = False,
                quant: bool = False) -> backend.KernelLayout:
    from repro_torch.kernels.moe_fused.ops import plan_expert_tiles
    tiles = plan_expert_tiles(seg_offsets, seg_experts)
    entry = ("grouped_ffn_ragged_quant_geometry" if quant
             else "grouped_ffn_ragged_geometry")
    return backend.KernelLayout(
        f"{name}[{label}]",
        span_launches(seg_offsets, seg_experts, d, f, swiglu, quant),
        meta={"seg_offsets": seg_offsets, "seg_experts": seg_experts,
              "tiles": tiles, "tile_kind": "expert_span",
              "geometry": ("moe_gemm", entry,
                           (d, f, tiles.shape[0], int(swiglu)))})


def dense_launches(E: int, C: int, d: int, f: int,
                   swiglu: bool = False) -> tuple:
    """K6's two 1-D launches over (expert, 128-row tile, 64 columns),
    columns innermost (``dense_block``)."""
    tpe = -(-C // K6_ROWS)

    def launch(name, ncols, smem):
        n = E * tpe * ncols
        first = tuple((b // ncols // tpe) * C + (b // ncols % tpe) * K6_ROWS
                      for b in range(n))
        rows = tuple(min(K6_ROWS, C - (b // ncols % tpe) * K6_ROWS)
                     for b in range(n))
        return backend.LaunchDecl(
            name, (n, 1, 1), THREADS, smem, K6_STATIC, THREADS,
            spans=(backend.Span("rows", E * C, first, rows),),
            writes=(backend.Write("out", lambda x, y, z: (
                first[x], first[x] + rows[x], x % ncols)),))

    return (launch(f"dense_up_kernel<{str(swiglu).lower()}>", f // 64,
                   K6_UP_SMEM[swiglu]),
            launch("dense_down_kernel", d // 64, K6_DOWN_SMEM))


@backend.register_kernel(KERNEL)
def _ragged_layouts():
    from repro_torch.kernels import layouts
    out = []
    for label, lay in (("2x2", layouts.staged()),
                       ("2x2x2", layouts.staged((2, 2, 2))),
                       ("ep2_tp2 f=1024", layouts.staged(
                           layouts.EP_TP_SIZES, model=layouts.TP_MODEL))):
        out.append(span_layout(KERNEL, f"{label} R={lay.slots}",
                               lay.seg_offsets, lay.seg_experts, lay.d,
                               lay.f))
    lay = layouts.staged()
    out.append(span_layout(KERNEL, "2x2 swiglu", lay.seg_offsets,
                           lay.seg_experts, lay.d, lay.f, swiglu=True))
    for name, aid in (("dsv2", layouts.DSV2_ID),
                      ("dsv2_236b", layouts.DSV2_236B_ID)):
        lay = layouts.dsv2_staged(arch_id=aid)
        out.append(span_layout(
            KERNEL, f"{name} 2x2 R={lay.slots} f={lay.f} swiglu",
            lay.seg_offsets, lay.seg_experts, lay.d, lay.f, swiglu=True))
    return out


@backend.register_kernel(KERNEL_QUANT)
def _quant_layouts():
    from repro_torch.kernels import layouts
    chunk0, whole = layouts.staged(num_chunks=8), layouts.staged()
    tp0 = layouts.staged(layouts.EP_TP_SIZES, num_chunks=8,
                         model=layouts.TP_MODEL)
    ds0 = layouts.dsv2_staged(pipelined=True)
    big0 = layouts.dsv2_staged(True, layouts.DSV2_236B_ID)
    return [span_layout(KERNEL_QUANT, f"2x2_pipelined_chunk0 R={chunk0.slots}",
                        chunk0.seg_offsets, chunk0.seg_experts, chunk0.d,
                        chunk0.f, quant=True),
            span_layout(KERNEL_QUANT,
                        f"ep2_tp2_pipelined_chunk0 R={tp0.slots} f={tp0.f}",
                        tp0.seg_offsets, tp0.seg_experts, tp0.d, tp0.f,
                        quant=True),
            span_layout(KERNEL_QUANT, f"2x2 R={whole.slots}",
                        whole.seg_offsets, whole.seg_experts, whole.d,
                        whole.f, quant=True),
            span_layout(KERNEL_QUANT, "2x2 swiglu", whole.seg_offsets,
                        whole.seg_experts, whole.d, whole.f, swiglu=True,
                        quant=True),
            span_layout(KERNEL_QUANT,
                        f"dsv2 2x2_pipelined_chunk0 R={ds0.slots} f={ds0.f}"
                        f" swiglu", ds0.seg_offsets, ds0.seg_experts,
                        ds0.d, ds0.f, swiglu=True, quant=True),
            span_layout(KERNEL_QUANT,
                        f"dsv2_236b 2x2_pipelined_chunk0 R={big0.slots} "
                        f"f={big0.f} swiglu", big0.seg_offsets,
                        big0.seg_experts, big0.d, big0.f, swiglu=True,
                        quant=True)]


@backend.register_kernel(KERNEL_DENSE)
def _dense_layouts():
    from repro_torch.kernels import layouts
    a = layouts.arch()
    E, d, f = a.moe.num_experts, a.d_model, a.moe.d_ff_expert
    out = []
    # the last: a model rank's f / TP_MODEL on train_tp2's einsum step
    for C, swiglu, ff in ((128, False, f), (200, False, f), (128, True, f),
                          (128, False, f // layouts.TP_MODEL)):
        out.append(backend.KernelLayout(
            f"{KERNEL_DENSE}[einsum [{E}, {C}, {d}]"
            f"{' swiglu' if swiglu else ''}{f' f={ff}' if ff != f else ''}]",
            dense_launches(E, C, d, ff, swiglu),
            meta={"geometry": ("moe_gemm", "grouped_ffn_dense_geometry",
                               (E, C, d, ff, int(swiglu)))}))
    return out
