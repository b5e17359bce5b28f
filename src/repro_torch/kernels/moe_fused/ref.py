"""Plain PyTorch version of the fused dispatch -> GEMM -> combine local MoE
(the counterpart of ``repro/kernels/moe_fused/ref.py``).

It is the three-step path composed from the plain pieces: permute
gather, ragged grouped FFN, weighted scatter-add combine.  The reference
drops the sentinel ``T`` in its scatter (``mode="drop"``); ``index_add_``
raises on an out-of-range index, so the combine scatters into one spare
row and slices it off.

:func:`compact_slots` is the plain mirror of the CUDA kernel's first
launch: the slots that carry a combine weight, segment by segment;
:func:`token_rows` of its token index: each token's live tile rows,
ascending, the order in which its combine sums them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
from repro_torch.kernels.moe_permute.ref import permute_ref

#: rows of one tile of the CUDA kernel's FFN launches (its BM)
TILE_ROWS = 64


def local_moe_ref(x, slot_to_token, slot_w, seg_offsets, seg_experts,
                  rows_valid, w_in, w_gate, w_out, *,
                  activation: str = "swiglu"):
    """x: [T, d]; slot_to_token: [S] in [0, T] (T = sentinel); slot_w: [S].
    Returns the float32 [T, d]
    ``out[t] = sum_{s: slot_to_token[s] == t} slot_w[s] * FFN(x[t])[s]``."""
    T, d = x.shape
    buf = permute_ref(x, slot_to_token)                          # [S, d]
    ys = grouped_ffn_ragged_ref(buf, seg_offsets, seg_experts, rows_valid,
                                w_in, w_gate, w_out, activation=activation)
    out = torch.zeros((T + 1, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, slot_to_token.long(),
                   ys.to(torch.float32) * slot_w[:, None].to(torch.float32))
    return out[:T]


def compact_slots(slot_to_token, slot_w, seg_offsets, rows_valid,
                  num_tokens: int):
    """The live slots of a segment layout: in each segment ``s``, the slots
    below ``rows_valid[s]`` (clamped to the segment) whose ``slot_w`` is
    nonzero and whose token is in ``[0, num_tokens)``, in their order.
    Returns ``(live [S] int32, count [n] int32)``: segment ``s``'s live
    slots fill ``live[seg_offsets[s] : seg_offsets[s] + count[s]]`` and -1
    the rest of its range.  A slot left out adds nothing to
    :func:`local_moe_ref`'s output (weight 0, or past the count, or the
    sentinel's dropped row), so the same call over the compacted layout
    gives the same output."""
    dev = slot_to_token.device
    S, n = slot_to_token.shape[0], len(seg_offsets) - 1
    offs = torch.as_tensor(seg_offsets, dtype=torch.int64, device=dev)
    slots = torch.arange(S, device=dev)
    seg = torch.searchsorted(offs[1:], slots, right=True)
    nvalid = torch.minimum(rows_valid.to(torch.int64).clamp(min=0),
                           offs[1:] - offs[:-1])
    tok = slot_to_token.to(torch.int64)
    keep = ((slots - offs[seg] < nvalid[seg]) & (slot_w != 0)
            & (tok >= 0) & (tok < num_tokens))
    kept = torch.cumsum(keep.to(torch.int64), 0)
    before = torch.cat([kept.new_zeros(1), kept])[offs[:-1]]
    rank = kept - 1 - before[seg]
    live = torch.full((S,), -1, dtype=torch.int32, device=dev)
    live[(offs[seg] + rank)[keep]] = slots[keep].to(torch.int32)
    count = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, seg, keep.to(torch.int64))
    return live, count.to(torch.int32)


def tile_starts(seg_offsets, tile_rows: int = TILE_ROWS):
    """Each segment's first tile row (int64 [n]): segments are cut into
    ``ceil(width / tile_rows)`` tiles each, in order (``ops.plan_tiles``),
    so segment ``s``'s live slot ``j`` (its ``j``-th in
    :func:`compact_slots`) lies at tile row ``tile_starts[s] + j``."""
    widths = torch.as_tensor(seg_offsets, dtype=torch.int64).diff()
    tiles = (widths + tile_rows - 1) // tile_rows
    return tile_rows * (torch.cumsum(tiles, 0) - tiles)


def token_rows(slot_to_token, slot_w, seg_offsets, rows_valid,
               num_tokens: int):
    """The token index of the CUDA kernel's combine, a CSR by token:
    ``(row_ptr [T + 1] int32, rows [n] int32)``, token ``t``'s live slots'
    tile rows (:func:`tile_starts`) ascending at ``rows[row_ptr[t] :
    row_ptr[t + 1]]``; ``n`` is the live slots' number.  Tile rows ascend
    with slots, so each list is in slot order."""
    dev = slot_to_token.device
    live, count = compact_slots(slot_to_token, slot_w, seg_offsets,
                                rows_valid, num_tokens)
    offs = torch.as_tensor(seg_offsets, dtype=torch.int64, device=dev)
    pos = torch.nonzero(live >= 0).flatten()
    seg = torch.searchsorted(offs[1:], pos, right=True)
    rows = tile_starts(seg_offsets).to(dev)[seg] + pos - offs[seg]
    tok = slot_to_token.to(torch.int64)[live[pos].long()]
    tok, order = torch.sort(tok, stable=True)
    n = torch.bincount(tok, minlength=num_tokens)
    row_ptr = torch.cat([n.new_zeros(1), torch.cumsum(n, 0)])
    return row_ptr.to(torch.int32), rows[order].to(torch.int32)
