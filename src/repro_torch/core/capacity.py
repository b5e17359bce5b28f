"""Level-indexed static capacity plans for the hierarchical all-to-all (the
counterpart of ``repro/core/capacity.py``, numpy and float64 arithmetic
copied as it is, so both packages give equal plans).

TA-MoE's Eq. (7) solution is piecewise-constant per topology level, so the
per-(source, expert) capacities reduce to one integer per *dispatch stage*
of the EP hierarchy.  Stage ``s`` delivers over the innermost ``s + 1``
axes and serves topology level ``s + 1``; the self level folds into stage 0.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import topology as topo_lib
from repro_torch.core.dispatch import wire


def _round_to(x: float, multiple: int) -> int:
    """Round up to a hardware-friendly multiple (>=1)."""
    return max(multiple, int(math.ceil(x / multiple)) * multiple)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def default_axis_names(n: int) -> tuple:
    """Canonical EP mesh-axis names, outermost-first: pod / node* / data."""
    if n == 1:
        return ("data",)
    if n == 2:
        return ("pod", "data")
    mids = tuple("node" if n == 3 else f"node{i}" for i in range(n - 2))
    return ("pod",) + mids + ("data",)


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Static dispatch capacities for one MoE layer on one EP topology.

    ``caps[s]`` is the per-(source device, expert) token capacity of
    dispatch stage ``s`` (0 = innermost; ``caps[s] == 0`` marks an inactive
    stage, e.g. the far stage of a single-pod mesh).  ``level_axes[s]`` is
    the mesh-axis chain stage ``s``'s exchange traverses (outermost-first),
    and ``axis_sizes`` are the EP mesh extents those chains are drawn from.
    Even dispatch (the DeepSpeed-MoE / FastMoE baseline) is the same
    structure with all active capacities equal.

    """

    tokens_per_device: int          # S_local * k assignments emitted
    num_experts: int                # N (global routed experts)
    experts_per_rank: int           # E_local on each EP rank
    caps: tuple                     # per-stage per-(src, expert) capacities
    ratios: tuple                   # full per-level multipliers from Eq. (7)
    mode: str                       # "even" | "ta" | "hir"
    axis_sizes: tuple = ()          # EP mesh extents, outermost-first
    level_axes: tuple = (("data",),)  # mesh-axis chain per stage
    level_sizes: tuple = ()         # |G_l| member counts per topology level
    num_chunks: int = 1             # pipelined dispatch: chunks per capacity

    @property
    def num_stages(self) -> int:
        return len(self.caps)

    @property
    def is_hierarchical(self) -> bool:
        return any(c > 0 for c in self.caps[1:])

    def active_stages(self) -> tuple:
        """Indices of stages with non-zero capacity."""
        return tuple(s for s, c in enumerate(self.caps) if c > 0)

    def chunk_cap(self, stage: int) -> int:
        """Per-chunk capacity of one stage (capacities are chunk-aligned)."""
        return self.caps[stage] // self.num_chunks

    def stage_dests(self, stage: int) -> int:
        """Remote destination ranks served by one stage."""
        n = len(self.axis_sizes)
        k = n - stage - 1
        return (self.axis_sizes[k] - 1) * _prod(self.axis_sizes[k + 1:])

    def stage_block(self, stage: int) -> int:
        """Ranks addressed by one stage's capacity buffer — the remote
        destinations plus the lower-stage block routing masks out (whose
        padded rows the expert FFN still computes)."""
        n = len(self.axis_sizes)
        return _prod(self.axis_sizes[n - stage - 1:])


def stage_ratio(ratios, level_sizes, stage: int) -> float:
    """Eq. (7) capacity multiplier for one dispatch stage.

    Stage ``s`` serves topology level ``s + 1``.  Degenerate
    single-member-level rule, stated explicitly: when a level has no
    members beyond self (``level_sizes[s + 1] == 0``, e.g. one device per
    pod), its Eq. (7) ratio is 0 by convention — for stage 0, which also
    carries the folded-in self traffic, the *self* ratio
    (``ratios[0]``) applies instead so the self chunk is never starved;
    for any outer stage the stage is simply inactive (capacity 0).
    """
    if level_sizes[stage + 1] > 0:
        return float(ratios[stage + 1])
    return float(ratios[0]) if stage == 0 else 0.0


def scale_comm_model(model, level_beta_scale) -> "topo_lib.CommModel":
    """Scale a CommModel's per-level inverse bandwidths.

    ``level_beta_scale[l] > 1`` marks topology level ``l`` as observed
    slower than the model's constant (a degraded link); ``math.inf``
    marks it unusable — its Eq. (7) ratio becomes exactly 0 (``1/inf``),
    collapsing the level toward local dispatch with the same convention
    :func:`stage_ratio` pins for memberless levels.  Scales shorter than
    the level count pad with 1.0.
    """
    scales = tuple(float(s) for s in level_beta_scale)
    scales = scales + (1.0,) * (len(model.beta) - len(scales))
    beta = tuple(b * s for b, s in zip(model.beta, scales))
    return topo_lib.CommModel(topo=model.topo, alpha=model.alpha, beta=beta)


def make_dispatch_plan(*, tokens_per_device: int, num_experts: int,
                       top_k: int, capacity_factor: float,
                       axis_sizes, axis_names=None, mode: str = "ta",
                       hir_ratio: float = 4.0, round_multiple: int = 8,
                       comm=None, level_beta_scale=None) -> DispatchPlan:
    """Build the level-indexed capacity plan for an N-axis EP hierarchy.

    ``axis_sizes`` are the EP mesh extents outermost-first (e.g.
    ``(pods, nodes, data)``); ``axis_names`` default to the canonical
    pod/node/data naming.  ``comm`` optionally supplies the per-level
    alpha-beta :class:`~repro.core.topology.CommModel` (defaults to the
    hardware-constant ladder of :func:`~repro.core.topology.tree_topology_nd`).
    ``level_beta_scale`` applies :func:`scale_comm_model` — the
    degraded-topology fallback re-solves the plan through it with the
    *observed* per-level slowdowns.

    mode="even": uniform capacity  C = k*S*cf/N         (paper baseline)
    mode="ta"  : per-stage C_s = ratio_{s+1} * C        (Eq. 7)
    mode="hir" : FasterMoE-style compulsory ratio — stage-0 capacity is
                 ``hir_ratio`` times the remote capacity regardless of
                 beta, renormalized to preserve total sent volume.
    """
    sizes = tuple(int(s) for s in axis_sizes)
    n = len(sizes)
    names = tuple(axis_names) if axis_names else default_axis_names(n)
    assert len(names) == n, (names, sizes)
    ep_world = _prod(sizes)
    experts_per_rank = max(1, math.ceil(num_experts / ep_world))
    assignments = tokens_per_device * top_k
    # even per-(src, expert) capacity
    c_even = assignments * capacity_factor / num_experts

    model = comm or topo_lib.tree_topology_nd(sizes)
    if level_beta_scale is not None:
        model = scale_comm_model(model, level_beta_scale)
    ratios = topo_lib.per_level_ratios(model)        # [n + 1]
    level_sizes = tuple(int(x) for x in model.topo.level_sizes(0))

    def active(s: int) -> bool:
        return s == 0 or sizes[n - s - 1] > 1

    if mode == "even":
        want = [c_even if active(s) else 0.0 for s in range(n)]
    elif mode == "ta":
        want = [c_even * stage_ratio(ratios, level_sizes, s) if active(s)
                else 0.0 for s in range(n)]
    elif mode == "hir":
        n_near = level_sizes[0] + level_sizes[1]
        n_far = sum(level_sizes[2:])
        if n_far == 0:
            want = [c_even if active(s) else 0.0 for s in range(n)]
        else:
            # hard ratio near:far = hir_ratio:1, preserving the total
            total = c_even * (n_near + n_far)
            far = total / (n_near * hir_ratio + n_far)
            want = [far * hir_ratio if s == 0 else
                    (far if active(s) else 0.0) for s in range(n)]
    else:
        raise ValueError(f"unknown mode {mode!r}")

    caps = tuple(_round_to(w, round_multiple) if w > 0 else 0 for w in want)
    level_axes = tuple(names[n - s - 1:] for s in range(n))
    return DispatchPlan(tokens_per_device=tokens_per_device,
                        num_experts=num_experts,
                        experts_per_rank=experts_per_rank,
                        caps=caps,
                        ratios=tuple(float(r) for r in ratios), mode=mode,
                        axis_sizes=sizes, level_axes=level_axes,
                        level_sizes=level_sizes)


def make_plan(*, tokens_per_device: int, num_experts: int, top_k: int,
              capacity_factor: float, num_pods: int, ep_per_pod: int,
              mode: str = "ta", hir_ratio: float = 4.0,
              round_multiple: int = 8) -> DispatchPlan:
    """2-level (pod x data) wrapper over :func:`make_dispatch_plan`.

    Same ``tpu_topology`` model and rounding as the reference's.
    """
    if num_pods > 1:
        sizes, names = (num_pods, ep_per_pod), ("pod", "data")
    else:
        sizes, names = (ep_per_pod,), ("data",)
    return make_dispatch_plan(
        tokens_per_device=tokens_per_device, num_experts=num_experts,
        top_k=top_k, capacity_factor=capacity_factor, axis_sizes=sizes,
        axis_names=names, mode=mode, hir_ratio=hir_ratio,
        round_multiple=round_multiple,
        comm=topo_lib.tpu_topology(num_pods, ep_per_pod))


def align_to_chunks(plan: DispatchPlan, num_chunks: int) -> DispatchPlan:
    """Round the plan's capacities up to multiples of ``num_chunks``.

    The pipelined dispatch slices each capacity buffer into ``num_chunks``
    equal static chunks per stage; rounding *up* preserves losslessness (a
    chunk-aligned plan never drops a token the unaligned plan kept — padding
    slots ride along as zero-weight rows).  ``num_chunks == 1`` returns the
    plan unchanged.
    """
    num_chunks = max(1, int(num_chunks))
    if num_chunks == 1:
        return dataclasses.replace(plan, num_chunks=1)
    caps = tuple(_round_to(c, num_chunks) if c else 0 for c in plan.caps)
    return dataclasses.replace(plan, caps=caps, num_chunks=num_chunks)


def a2a_bytes(plan: DispatchPlan, d_model: int, bytes_per_el: int,
              codec=None) -> dict:
    """Bytes each device moves per all-to-all stage (send side).

    Returns ``by_level`` (one entry per dispatch stage) plus the 2-level
    ``near_bytes`` / ``far_bytes`` sums.  ``codec`` (a
    ``core.dispatch.wire`` codec or its registered name) sets the payload
    element size to the wire dtype's and, for scaled codecs, adds the f32
    scale sideband: one scale per (destination, expert) segment.
    """
    codec = wire.get_codec(codec)
    payload_b = bytes_per_el if codec is None else codec.wire_bytes_per_elem
    scaled = codec is not None and codec.scaled
    E = plan.experts_per_rank

    def stage_bytes(s: int) -> int:
        if not plan.caps[s]:
            return 0
        b = plan.caps[s] * E * plan.stage_dests(s) * d_model * payload_b
        if scaled:
            b += E * plan.stage_dests(s) * 4   # one f32 scale per segment
        return b

    by_level = tuple(stage_bytes(s) for s in range(plan.num_stages))
    return {"by_level": by_level,
            "near_bytes": by_level[0],
            "far_bytes": sum(by_level[1:])}
