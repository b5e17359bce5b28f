"""Grouped-FFN block planning (the counterpart of
``repro/kernels/moe_gemm/ops.py``; the ragged GEMM kernel itself, K3, is
still to be ported).

:func:`plan_blocks` is the reference's gcd-divisor decomposition, kept so
the port can state the reference's block layout; the CUDA local-MoE
kernel plans fixed row tiles instead (``moe_fused.ops.plan_tiles``),
because the gcd rule gives 8-row blocks at decode.
"""

import math

import numpy as np


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
