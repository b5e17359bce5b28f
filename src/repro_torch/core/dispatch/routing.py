"""Routing stages: gate forward, per-topology-level token selection, and the
flattened sort-order indices of the staged paths (the counterpart of
``repro/core/dispatch/routing.py``).

Selections are ``Selection(w, idx, valid, buf, eid)`` named tuples:

    w      [..., cap]      combine weight per selected slot (-1 = empty)
    idx    [..., cap]      source-token index of each slot
    valid  [..., cap]      1.0 where the slot holds a real token
    buf    [..., cap, d]   always None here: the engine builds the payload
                           through the moe_permute kernels from the
                           flattened indices (the reference's
                           ``route(with_bufs=False)``)
    eid    [..., cap]      global expert id each slot feeds

Stage ``s``'s selection has ``s + 1`` leading destination dims (the
innermost ``s + 1`` EP axes, outermost first).  :func:`build_indices`
flattens the selections of the active stages into the (stage,
destination, expert, slot) sort order.

Top-k over score rows that are mostly -1 makes ties the rule, so the
selection uses the stable descending sort of ``gating.topk_stable``
(``jax.lax.top_k`` keeps the lower index first on ties).  A rank's
coordinates come from the EP world (``launch.mesh``), not from
``axis_index``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import gating
from repro_torch.core.capacity import DispatchPlan
from repro_torch.core.dispatch.base import EPSpec, MoEConfig


class Selection(NamedTuple):
    """Per-(destination, capacity-slot) token selection."""
    w: torch.Tensor
    idx: torch.Tensor
    valid: torch.Tensor
    buf: torch.Tensor | None = None
    eid: torch.Tensor | None = None


class Routing(NamedTuple):
    """Output of :func:`route`: ``sels[i]`` is ``(stage_index,
    Selection)`` for each active plan stage, in stage order.  ``near`` /
    ``far`` are deprecated 2-level views."""
    sels: tuple
    gate_out: dict
    aux: torch.Tensor
    levels: torch.Tensor

    @property
    def near(self):
        """Deprecated: the stage-0 selection."""
        return self.sels[0][1] if self.sels and self.sels[0][0] == 0 else None

    @property
    def far(self):
        """Deprecated: the stage-1 selection (None on single-stage plans)."""
        for s, sel in self.sels:
            if s == 1:
                return sel
        return None


def score_matrix(gate_out, num_experts: int):
    """[N, T] combine-weight matrix; -1 marks 'token did not pick expert'."""
    topk_idx, topk_w = gate_out["topk_idx"], gate_out["topk_weight"]
    T = topk_idx.shape[0]
    s = torch.full((T, num_experts), -1.0, dtype=torch.float32,
                   device=topk_idx.device)
    s.scatter_(1, topk_idx.long(), topk_w.to(torch.float32))
    return s.T


def select(score_rows, x, cap: int, eids=None) -> Selection:
    """Top-``cap`` tokens for each leading row of ``score_rows`` [..., T]
    (ties toward the lower token index).  ``eids`` (the leading dims'
    shape) records the global expert id of each row."""
    cap = min(cap, score_rows.shape[-1])
    w, idx = gating.topk_stable(score_rows, cap)
    valid = (w > 0).to(x.dtype)
    eid = eids[..., None].expand(idx.shape) if eids is not None else None
    return Selection(w, idx, valid, None, eid)


def _prod(xs) -> int:
    out = 1
    for v in xs:
        out *= int(v)
    return out


def _rank_offsets(inner_sizes, device) -> torch.Tensor:
    """Mixed-radix rank offsets of shape ``inner_sizes`` (outermost-major)."""
    offs = torch.zeros(tuple(inner_sizes), dtype=torch.int64, device=device)
    stride = 1
    for j in range(len(inner_sizes) - 1, -1, -1):
        shape = [1] * len(inner_sizes)
        shape[j] = inner_sizes[j]
        offs = offs + torch.arange(inner_sizes[j], device=device).reshape(
            shape) * stride
        stride *= inner_sizes[j]
    return offs


def route(params, x, cfg: MoEConfig, ep: EPSpec, plan: DispatchPlan,
          gate_cfg: gating.GateConfig, coords: tuple) -> Routing:
    """Gating + per-level token selection for the staged (a2a) paths.

    ``coords`` are this rank's coordinates on the EP axes (outermost
    first).  Stage ``s`` targets the experts of ranks sharing this rank's
    coordinates on all axes above the innermost ``s + 1``, at capacity
    ``plan.caps[s]``.  Destinations already reachable at a lower stage are
    masked to -1, except at stage 0, whose buffer also carries the
    folded-in self traffic.
    """
    sizes = ep.axis_sizes
    n = len(sizes)
    if plan.num_stages != n:
        raise ValueError(f"plan has {plan.num_stages} stages but the EP spec "
                         f"spans {n} axes {ep.axis_names}; rebuild the plan")
    E_l = plan.experts_per_rank
    dev = x.device
    my_rank = 0
    for c, s in zip(coords, sizes):
        my_rank = my_rank * s + int(c)

    levels = gating.expert_levels_nd(cfg.num_experts, E_l, sizes, coords,
                                     device=dev)
    gate_out = gating.gate_forward(params["gate"], x, gate_cfg, levels)
    aux = gating.aux_loss(gate_out, gate_cfg, levels)
    score = score_matrix(gate_out, cfg.num_experts)            # [N, T]

    sels = []
    for s in range(plan.num_stages):
        cap = plan.caps[s]
        if cap <= 0:
            continue
        k = n - s - 1                      # outermost free axis position
        inner = sizes[k:]
        block = _prod(inner)
        base = (my_rank // block) * block  # my rank with inner coords zeroed
        ranks = base + _rank_offsets(inner, dev)                # [*inner]
        eids = ranks[..., None] * E_l + torch.arange(E_l, device=dev)
        sc = score[eids]                                  # [*inner, E_l, T]
        if s > 0:
            own = (torch.arange(sizes[k], device=dev) == int(coords[k]))
            sc = torch.where(own.reshape((sizes[k],) + (1,) * (len(inner) + 1)),
                             -1.0, sc)
        sels.append((s, select(sc, x, cap, eids=eids)))
    return Routing(tuple(sels), gate_out, aux, levels)


def pad_selection(sel: Selection, axis: int, multiple: int) -> Selection:
    """Zero-pad a selection's capacity axis up to a multiple of
    ``multiple`` (padded slots: ``valid == 0``, ``idx == 0``, weight 0)."""
    pad = (-sel.w.shape[axis]) % multiple
    if pad == 0:
        return sel

    def _pad(a):
        if a is None:
            return None
        shape = list(a.shape)
        shape[axis] = pad
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    return Selection(*(_pad(a) for a in sel))


def slice_selection(sel: Selection, axis: int, start: int,
                    size: int) -> Selection:
    """Static slice of a selection's capacity axis (one pipeline chunk)."""
    return Selection(*(None if a is None else a.narrow(axis, start, size)
                       for a in sel))


class DispatchIndices(NamedTuple):
    """Flattened sort-order view of one set of per-stage selections.

    The flat slot order is (stage, destination..., expert, capacity-slot).
    ``slot_to_token[s]`` is the source token of slot ``s`` (sentinel ``T``
    for empty slots) and ``slot_w`` its combine weight (0 when empty);
    ``inv_idx[t, k]`` / ``inv_w[t, k]`` locate and weight token ``t``'s
    ``k``-th expert pick among the slots (sentinel ``S`` when the pick was
    dropped or lives outside this selection set).  ``shapes`` are the
    static per-stage ``idx`` shapes, in stage order; ``rows_per_expert``
    the runtime valid-row count of every (stage, destination..., expert)
    segment, in slot order (valid slots are a prefix of each segment).
    """
    slot_to_token: torch.Tensor   # [S] int32, sentinel T
    slot_w: torch.Tensor          # [S] f32, 0 for empty slots
    inv_idx: torch.Tensor         # [T, K] int32, sentinel S
    inv_w: torch.Tensor           # [T, K] f32, 0 for dropped picks
    shapes: tuple                 # ((stage_idx, idx_shape), ...)
    rows_per_expert: torch.Tensor | None = None   # [num segments] int32

    @property
    def num_slots(self) -> int:
        return self.slot_to_token.shape[0]

    def stage_spans(self) -> tuple:
        """Static (stage_idx, start, shape) row spans of the flat buffer."""
        spans, off = [], 0
        for s, shape in self.shapes:
            spans.append((s, off, shape))
            off += _prod(shape)
        return tuple(spans)

    def expert_spans(self) -> tuple:
        """Static (stage_idx, start, shape) spans of ``rows_per_expert``:
        ``shape`` is the per-stage count shape [*dests, E_local]."""
        spans, off = [], 0
        for s, shape in self.shapes:
            spans.append((s, off, shape[:-1]))
            off += _prod(shape[:-1])
        return tuple(spans)


def build_indices(sels, topk_idx, num_tokens: int) -> DispatchIndices:
    """Selections -> sort indices + inverse map.

    ``sels`` is ``((stage_idx, Selection), ...)``.  A (token, expert) pair
    occupies at most one slot globally, so the inverse is a scatter with no
    collisions; the sentinel writes land in one spare row that is sliced
    off (JAX's ``mode="drop"``).
    """
    parts_tok, parts_w, parts_valid, parts_eid = [], [], [], []
    shapes, parts_cnt = [], []
    for s, sel in sels:
        if sel.eid is None:
            raise ValueError("build_indices needs Selection.eid")
        shapes.append((s, tuple(sel.idx.shape)))
        parts_tok.append(sel.idx.reshape(-1))
        parts_w.append(sel.w.reshape(-1))
        parts_valid.append(sel.valid.reshape(-1))
        parts_eid.append(sel.eid.reshape(-1))
        parts_cnt.append(torch.sum(sel.valid > 0, dim=-1,
                                   dtype=torch.int32).reshape(-1))

    tok = torch.cat(parts_tok).to(torch.int32)
    valid = torch.cat(parts_valid) > 0
    w = torch.where(valid, torch.cat(parts_w).to(torch.float32), 0.0)
    eid = torch.cat(parts_eid)
    S = tok.shape[0]
    K = topk_idx.shape[1]
    dev = tok.device
    sentinel_t = torch.full_like(tok, num_tokens)

    slot_to_token = torch.where(valid, tok, sentinel_t)
    # which of its token's K picks each slot serves (valid slots always
    # match: w > 0 means the token picked this slot's expert); argmax keeps
    # the first maximum, as jnp.argmax does
    match = topk_idx[tok.long()] == eid[:, None]                   # [S, K]
    k_of_slot = torch.argmax(match.to(torch.int32), dim=1)
    t_scatter = slot_to_token.long()
    inv_idx = torch.full((num_tokens + 1, K), S, dtype=torch.int32,
                         device=dev)
    inv_idx[t_scatter, k_of_slot] = torch.arange(S, dtype=torch.int32,
                                                 device=dev)
    inv_w = torch.zeros((num_tokens + 1, K), dtype=torch.float32, device=dev)
    inv_w[t_scatter, k_of_slot] = w
    return DispatchIndices(slot_to_token, w, inv_idx[:num_tokens],
                           inv_w[:num_tokens], tuple(shapes),
                           torch.cat(parts_cnt))


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
