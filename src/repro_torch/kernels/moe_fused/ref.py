"""Plain PyTorch version of the fused dispatch -> GEMM -> combine local MoE
(the counterpart of ``repro/kernels/moe_fused/ref.py``).

It is the three-step path composed from the plain pieces: permute
gather, ragged grouped FFN, weighted scatter-add combine.  The reference
drops the sentinel ``T`` in its scatter (``mode="drop"``); ``index_add_``
raises on an out-of-range index, so the combine scatters into one spare
row and slices it off.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
from repro_torch.kernels.moe_permute.ref import permute_ref


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
