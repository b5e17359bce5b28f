"""Plain PyTorch versions of the grouped expert FFN, dense, ragged and
int8-quantized ragged (the counterpart of ``repro/kernels/moe_gemm/ref.py``).

The activation is gelu's tanh form (``jax.nn.gelu``'s default) or
``silu(x @ w_gate) * (x @ w_in)``; products run in float32 and the hidden
activation is rounded to the model dtype before the down-projection, as
the reference's kernels do.  The quantized version's int8 x int8 products
run in float64, which holds their sums exactly (CUDA has no integer
matmul in torch, and a float32 product would be exact only with TF32 off).
"""

import numpy as np
import torch
import torch.nn.functional as F


def _activate(h, g, activation: str):
    if activation == "swiglu" and g is not None:
        return F.silu(g) * h
    return F.gelu(h, approximate="tanh")


def grouped_ffn_ref(x, w_in, w_gate, w_out, *, activation: str = "swiglu"):
    """x: [E, C, d]; w_in/w_gate: [E, d, f]; w_out: [E, f, d] -> [E, C, d]
    in x's dtype."""
    xf = x.to(torch.float32)
    h = torch.einsum("ecd,edf->ecf", xf, w_in.to(torch.float32))
    g = None
    if activation == "swiglu" and w_gate is not None:
        g = torch.einsum("ecd,edf->ecf", xf, w_gate.to(torch.float32))
    h = _activate(h, g, activation)
    y = torch.einsum("ecf,efd->ecd", h.to(x.dtype).to(torch.float32),
                     w_out.to(torch.float32))
    return y.to(x.dtype)


def segment_relayout_maps(src_offsets, dst_offsets):
    """Static numpy index maps re-laying flat segment rows into a padded
    segment layout: ``gather[p]`` is the source row of destination row
    ``p`` (``R`` = the appended zero row for pad rows) and ``carve[r]`` the
    destination position of source row ``r``."""
    src = np.asarray(src_offsets, np.int64)
    dst = np.asarray(dst_offsets, np.int64)
    R, Rp = int(src[-1]), int(dst[-1])
    widths = src[1:] - src[:-1]
    p = np.arange(Rp)
    seg_p = np.searchsorted(dst[1:], p, side="right")
    local = p - dst[seg_p]
    gather = np.where(local < widths[seg_p], src[seg_p] + local, R)
    r = np.arange(R)
    seg_r = np.searchsorted(src[1:], r, side="right")
    carve = dst[seg_r] + (r - src[seg_r])
    return gather, carve


def _segment_view(x, offs, S, cmax):
    """[R, d] flat segments -> ([S, cmax, d] view, carve map or None for
    equal widths)."""
    widths = offs[1:] - offs[:-1]
    if bool((widths == cmax).all()):
        return x.reshape(S, cmax, -1), None
    gather, carve = segment_relayout_maps(offs, np.arange(S + 1) * cmax)
    xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return xz[torch.as_tensor(gather.reshape(S, cmax), device=x.device)], \
        carve


def _valid_mask(offs, rows_valid, S, cmax, device):
    """[S, cmax] bool: the row lies in its segment and below
    ``rows_valid`` (None: every row of the segment)."""
    widths = offs[1:] - offs[:-1]
    row = np.arange(cmax)[None, :]
    mask = torch.as_tensor(row < widths[:, None], device=device)
    if rows_valid is not None:
        rv = torch.as_tensor(rows_valid, device=device).to(torch.int64)
        mask = mask & (torch.as_tensor(row, device=device) < rv[:, None])
    return mask


def _absmax_scale(absmax, qmax: float):
    return torch.where(absmax > 0, absmax,
                       torch.full_like(absmax, qmax)) / qmax


def quantize_segments(x, seg_offsets, *, qmax: float = 127.0):
    """Per-segment symmetric int8 quantization of a flat [R, d] buffer: one
    f32 scale per contiguous segment (its absmax / ``qmax``; 1 for an
    all-zero or empty segment).  Returns ``(q int8 [R, d], scale [S])``."""
    offs = np.asarray([int(o) for o in seg_offsets], np.int64)
    S = len(offs) - 1
    seg_ids = torch.as_tensor(
        np.searchsorted(offs[1:], np.arange(int(offs[-1])), side="right"),
        device=x.device)
    xf = x.to(torch.float32)
    row_max = xf.abs().amax(dim=-1)
    absmax = torch.zeros(S, dtype=torch.float32, device=x.device) \
        .scatter_reduce(0, seg_ids, row_max, "amax")
    scale = _absmax_scale(absmax, qmax)
    q = torch.clamp(torch.round(xf / scale[seg_ids][:, None]), -qmax, qmax)
    return q.to(torch.int8), scale


def quantize_experts(w, *, qmax: float = 127.0):
    """Per-expert symmetric int8 quantization of [E, d, f] weights ->
    ``(q int8, scale [E])``."""
    wf = w.to(torch.float32)
    scale = _absmax_scale(wf.abs().amax(dim=(1, 2)), qmax)
    q = torch.clamp(torch.round(wf / scale[:, None, None]), -qmax, qmax)
    return q.to(torch.int8), scale


def _per_expert(a, w, exps, dtype):
    """Per segment ``s`` of ``a [S, cmax, k]``: ``a[s] @ w[exps[s]]`` in
    ``dtype``, one product per expert (no per-segment weight copies)."""
    S, cmax, _ = a.shape
    out = a.new_empty((S, cmax, w.shape[-1]), dtype=dtype)
    a = a.to(dtype)
    for e in sorted(set(exps)):
        sel = torch.as_tensor([s for s, ee in enumerate(exps) if ee == e],
                              device=a.device)
        out[sel] = a[sel] @ w[e].to(dtype)
    return out


def grouped_ffn_ragged_quant_ref(x, seg_offsets, seg_experts, rows_valid,
                                 w_in, w_gate, w_out, *,
                                 activation: str = "swiglu"):
    """The int8 ragged grouped FFN (K7's plain version): the segment layout
    and zero-row contract of :func:`grouped_ffn_ragged_ref`, with the up
    projections as per-segment int8 activations x per-expert int8 weights,
    exact integer sums dequantized by ``scale_x[s] * scale_w[e]`` in f32
    before the activation; the down-projection stays in the model dtype
    with f32 sums."""
    offs = np.asarray([int(o) for o in seg_offsets], np.int64)
    exps = tuple(int(e) for e in seg_experts)
    S = len(exps)
    R = x.shape[0]
    if not (offs.shape[0] == S + 1 and offs[0] == 0 and offs[-1] == R):
        raise ValueError(f"bad segment layout {offs} for {S} segments and "
                         f"{R} rows")
    if not S or R == 0:
        return torch.zeros_like(x)
    cmax = int((offs[1:] - offs[:-1]).max())
    dev = x.device
    xs, carve = _segment_view(x, offs, S, cmax)
    mask = _valid_mask(offs, rows_valid, S, cmax, dev)
    xf = xs.to(torch.float32) * mask[..., None]

    # per-segment activation scales on the masked view (equal to the flat
    # buffer's under the zero-slot convention)
    qmax = 127.0
    sx = _absmax_scale(xf.abs().amax(dim=(1, 2)), qmax)          # [S]
    xq = torch.clamp(torch.round(xf / sx[:, None, None]), -qmax, qmax)
    eid = torch.as_tensor(exps, dtype=torch.int64, device=dev)
    q_in, s_in = quantize_experts(w_in, qmax=qmax)
    h = _per_expert(xq, q_in, exps, torch.float64).to(torch.float32) \
        * (sx * s_in[eid])[:, None, None]
    g = None
    if activation == "swiglu" and w_gate is not None:
        q_g, s_g = quantize_experts(w_gate, qmax=qmax)
        g = _per_expert(xq, q_g, exps, torch.float64).to(torch.float32) \
            * (sx * s_g[eid])[:, None, None]
    h = _activate(h, g, activation).to(w_out.dtype)
    ys = _per_expert(h, w_out, exps, torch.float32)
    ys = (ys * mask[..., None]).to(x.dtype)
    if carve is None:
        return ys.reshape(R, -1)
    return ys.reshape(S * cmax, -1)[torch.as_tensor(carve, device=dev)]


def grouped_ffn_ragged_ref(x, seg_offsets, seg_experts, rows_valid, w_in,
                           w_gate, w_out, *, activation: str = "swiglu"):
    """Occupancy-aware ragged grouped FFN on a flat [R, d] buffer of static
    contiguous segments: segment ``s`` owns rows
    ``seg_offsets[s]:seg_offsets[s + 1]`` and multiplies expert
    ``seg_experts[s]``.  Rows at or past ``rows_valid[s]`` (runtime [S], or
    None = fully occupied) are masked on input and zero on output."""
    offs = np.asarray([int(o) for o in seg_offsets], np.int64)
    exps = tuple(int(e) for e in seg_experts)
    S = len(exps)
    R = x.shape[0]
    if not (offs.shape[0] == S + 1 and offs[0] == 0 and offs[-1] == R):
        raise ValueError(f"bad segment layout {offs} for {S} segments and "
                         f"{R} rows")
    if not S or R == 0:
        return torch.zeros_like(x)
    cmax = int((offs[1:] - offs[:-1]).max())
    dev = x.device
    xs, carve = _segment_view(x, offs, S, cmax)
    mask = _valid_mask(offs, rows_valid, S, cmax, dev)
    xs = xs * mask[..., None].to(xs.dtype)

    eid = torch.as_tensor(exps, dtype=torch.int64, device=dev)
    wg = None if w_gate is None else w_gate.index_select(0, eid)
    ys = grouped_ffn_ref(xs, w_in.index_select(0, eid), wg,
                         w_out.index_select(0, eid), activation=activation)
    ys = ys * mask[..., None].to(ys.dtype)
    if carve is None:
        return ys.reshape(R, -1)
    return ys.reshape(S * cmax, -1)[torch.as_tensor(carve, device=dev)]
