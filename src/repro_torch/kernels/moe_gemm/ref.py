"""Plain PyTorch versions of the grouped expert FFN, dense and ragged (the
counterpart of ``repro/kernels/moe_gemm/ref.py``).

The activation is gelu's tanh form (``jax.nn.gelu``'s default) or
``silu(x @ w_gate) * (x @ w_in)``; products run in float32 and the hidden
activation is rounded to the model dtype before the down-projection, as
the reference's kernels do.
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
    widths = offs[1:] - offs[:-1]
    if not S or R == 0:
        return torch.zeros_like(x)
    cmax = int(widths.max())
    dev = x.device

    row = np.arange(cmax)[None, :]
    in_seg = torch.as_tensor(row < widths[:, None], device=dev)
    equal = bool((widths == cmax).all())
    if equal:
        xs = x.reshape(S, cmax, -1)
    else:
        gather, carve = segment_relayout_maps(offs, np.arange(S + 1) * cmax)
        xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        xs = xz[torch.as_tensor(gather.reshape(S, cmax), device=dev)]

    mask = in_seg
    if rows_valid is not None:
        rv = torch.as_tensor(rows_valid, device=dev).to(torch.int64)
        mask = mask & (torch.as_tensor(row, device=dev) < rv[:, None])
    xs = xs * mask[..., None].to(xs.dtype)

    eid = torch.as_tensor(exps, dtype=torch.int64, device=dev)
    wg = None if w_gate is None else w_gate.index_select(0, eid)
    ys = grouped_ffn_ref(xs, w_in.index_select(0, eid), wg,
                         w_out.index_select(0, eid), activation=activation)
    ys = ys * mask[..., None].to(ys.dtype)
    if equal:
        return ys.reshape(R, -1)
    return ys.reshape(S * cmax, -1)[torch.as_tensor(carve, device=dev)]
