"""Routing stages of the weights-stationary ``gather`` path (the
counterpart of ``repro/core/dispatch/routing.py``: ``gather_inverse`` and
``gather_weights``; the staged paths' ``route`` / ``select`` /
``build_indices`` come with the a2a slice).
"""

from __future__ import annotations

import torch


def gather_inverse(gate_out, my_rank: int, experts_per_rank: int,
                   num_tokens: int):
    """Inverse pick map of the gather path's dense [E_l, Tg] slot grid
    (slot ``e * Tg + t`` = expert ``e``'s output for token ``t``).
    Returns ``(inv_idx, inv_w)`` [Tg, K]; picks owned by other ranks point
    at the sentinel ``E_l * Tg`` with weight 0."""
    topk_idx, topk_w = gate_out["topk_idx"], gate_out["topk_weight"]
    e_local = topk_idx - my_rank * experts_per_rank
    local = (e_local >= 0) & (e_local < experts_per_rank)
    sentinel = experts_per_rank * num_tokens
    t = torch.arange(num_tokens, device=topk_idx.device)[:, None]
    inv_idx = torch.where(local, e_local * num_tokens + t,
                          sentinel).to(torch.int32)
    inv_w = torch.where(local, topk_w, 0.0).to(torch.float32)
    return inv_idx, inv_w


def gather_weights(gate_out, my_rank: int, experts_per_rank: int):
    """[Tg, E_l] combine weight of each of this rank's experts per token
    (0 where the token did not pick the expert)."""
    my_eids = my_rank * experts_per_rank + torch.arange(
        experts_per_rank, device=gate_out["topk_idx"].device)
    sel = gate_out["topk_idx"][:, :, None] == my_eids[None, None, :]
    return torch.sum(torch.where(sel, gate_out["topk_weight"][:, :, None],
                                 0.0), dim=1)


def gather_slots(gate_out, my_rank: int, experts_per_rank: int):
    """The gather path's fused slot layout: slot ``e * Tg + t`` maps token
    ``t`` through local expert ``e``.  Returns ``(slot_to_token [S] int32,
    slot_w [S] float32, rows_valid [E_l] int32)``; an expert picked by no
    token has 0 valid rows (its whole segment is skipped)."""
    wts = gather_weights(gate_out, my_rank, experts_per_rank)   # [Tg, E_l]
    Tg = wts.shape[0]
    valid = torch.where(torch.any(wts > 0, dim=0), Tg, 0).to(torch.int32)
    slot_tok = torch.arange(Tg, dtype=torch.int32,
                            device=wts.device).repeat(experts_per_rank)
    slot_w = wts.T.reshape(-1).to(torch.float32).contiguous()
    return slot_tok, slot_w, valid
