"""Top-level model API: context building and parameter init (the
counterpart of ``repro/models/model.py``: ``make_ep_spec``, ``make_plan``,
``make_gate_cfg``, ``build_ctx``, ``init_params``).

``mesh`` is the EP world of this rank (``launch.mesh.EPWorld``) or None
for one rank: its axes play the part of the reference's mesh hierarchy
axes (there is no tensor-parallel ``model`` axis in the port yet).
Parameters are this rank's: replicated tensors whole, expert tensors the
rank's shard of the expert axis.  ``build_ctx`` takes the reference's
keywords and raises ``NotImplementedError`` for the options whose code is
not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import capacity, comm_model, gating, topology
from repro_torch.core.dispatch import base as moe_base
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.core.dispatch import wire
from repro_torch.models import transformer


def _hierarchy(mesh) -> tuple:
    """(axis names, axis sizes) of the EP world's hierarchy, outermost
    first; one ``data`` axis of size 1 without a world."""
    if mesh is None:
        return ("data",), (1,)
    return tuple(mesh.axis_names), tuple(mesh.axis_sizes)


def make_ep_spec(arch: ArchConfig, mesh=None) -> moe_base.EPSpec | None:
    """EP hierarchy for one world: experts span the longest *suffix* of
    the axes (innermost outward) whose extent divides the expert count —
    the whole hierarchy when possible, fewer tiers otherwise."""
    if not arch.is_moe:
        return None
    axes, sizes = _hierarchy(mesh)
    while len(sizes) > 1 and sizes[0] == 1:   # degenerate outer tiers
        axes, sizes = axes[1:], sizes[1:]
    n = arch.moe.num_experts
    for k in range(len(axes)):                # longest suffix first
        world = math.prod(sizes[k:])
        if k == len(axes) - 1 or (n % world == 0 and n >= world):
            return moe_base.EPSpec.from_axes(axes[k:], sizes[k:])
    return moe_base.EPSpec.from_axes(axes[-1:], sizes[-1:])


def make_plan(arch: ArchConfig, mesh, seq_len: int, global_batch: int,
              mode: str) -> capacity.DispatchPlan | None:
    if not arch.is_moe:
        return None
    ep = make_ep_spec(arch, mesh)
    nshard = math.prod(_hierarchy(mesh)[1])
    tokens_per_device = max(1, (global_batch * seq_len) // nshard)
    return capacity.make_dispatch_plan(
        tokens_per_device=tokens_per_device,
        num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor,
        axis_sizes=ep.axis_sizes, axis_names=ep.axis_names, mode=mode,
        comm=topology.tree_topology_nd(ep.axis_sizes))


def make_gate_cfg(arch: ArchConfig, plan, ep, aux_mode: str,
                  ) -> gating.GateConfig | None:
    """Gate config; under ``aux_mode="ta"`` the Eq. (8) penalties come from
    the plan's full ratio vector and per-level member counts."""
    if not arch.is_moe:
        return None
    n_levels = max(3, len(plan.ratios) if plan is not None else 3)
    penalties = (1.0,) * n_levels
    if aux_mode == "ta" and plan is not None:
        penalties = gating.ta_penalties(plan.ratios,
                                        level_sizes=plan.level_sizes)
        if len(penalties) < 3:
            penalties = penalties + (penalties[-1],) * (3 - len(penalties))
    return gating.GateConfig(
        num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor, aux_mode=aux_mode,
        penalty_by_level=penalties)


def resolve_num_chunks(arch: ArchConfig, plan, num_chunks: int = 0, *,
                       wire_codec=None) -> int:
    """Chunk count of the pipelined dispatch; 0 picks it with the overlap
    model (``comm_model``, the reference's link and peak constants).
    ``wire_codec`` rescales the exchange bytes to the wire encoding, so a
    codec swap can change the verdict."""
    if num_chunks > 0:
        return int(num_chunks)
    terms = comm_model.moe_overlap_terms(
        plan, d_model=arch.d_model, d_ff=arch.moe.d_ff_expert,
        bytes_per_el=2 if arch.torch_dtype == torch.bfloat16 else 4,
        activation=arch.activation, codec=wire_codec)
    return comm_model.choose_num_chunks(**terms)


def build_ctx(arch: ArchConfig, mesh=None, *, seq_len: int = 0,
              global_batch: int = 0, aux_mode: str = "ta",
              remat: bool = False, decode_replicated: bool = False,
              use_flash: bool = False, use_moe_kernel: bool = False,
              dispatch: str = "a2a", a2a_num_chunks: int = 0,
              dispatch_override: tuple = (), measured_comm: bool = False,
              use_pallas=None, wire_codec="", resilience=None,
              device="cuda") -> transformer.ModelCtx:
    """The model context.  ``seq_len`` / ``global_batch`` size the a2a
    capacity plan (tokens per rank = global tokens / world size).  When
    any layer takes ``a2a_pipelined``, ``a2a_num_chunks`` (0: the overlap
    model's pick) sets the chunk count and the plan's capacities round up
    to a multiple of it.  ``device`` is where parameters and caches
    live."""
    if aux_mode not in ("lb", "ta", "hir", "none"):
        raise ValueError(f"unknown aux_mode {aux_mode!r}")
    if remat:
        raise NotImplementedError("remat applies to the training forward, "
                                  "not ported yet")
    if use_moe_kernel:
        raise NotImplementedError("use_moe_kernel needs the dense grouped "
                                  "FFN kernel (K6), not ported yet")
    if measured_comm:
        raise NotImplementedError("measured_comm needs the link "
                                  "micro-benchmark (comm_model.measure_link), "
                                  "not ported yet")
    if resilience is not None:
        raise NotImplementedError("the resilient runtime is not ported yet")
    codec = wire.get_codec(wire_codec)
    if arch.is_moe and arch.moe.dispatch_override:
        merged = dict(arch.moe.dispatch_override)
        merged.update(dict(dispatch_override))
        dispatch_override = tuple(sorted(merged.items()))
    else:
        dispatch_override = tuple(sorted(dict(dispatch_override).items()))
    for name in (dispatch,) + tuple(n for _, n in dispatch_override):
        dispatch_lib.check_name(name)
    dispatch_mode = {"lb": "even", "ta": "ta", "hir": "hir",
                     "none": "even"}[aux_mode]
    plan = make_plan(arch, mesh, seq_len, global_batch, dispatch_mode)
    ep = make_ep_spec(arch, mesh)
    gate_cfg = make_gate_cfg(arch, plan, ep, aux_mode)
    num_chunks = 1
    pipelined = (dispatch == "a2a_pipelined"
                 or any(n == "a2a_pipelined" for _, n in dispatch_override))
    if plan is not None and pipelined:
        num_chunks = resolve_num_chunks(arch, plan, a2a_num_chunks,
                                        wire_codec=codec)
        plan = capacity.align_to_chunks(plan, num_chunks)
    return transformer.ModelCtx(
        arch=arch, mesh=mesh, ep=ep, plan=plan, gate_cfg=gate_cfg,
        use_flash=use_flash,
        decode_replicated=decode_replicated, dispatch=dispatch,
        a2a_num_chunks=num_chunks, dispatch_override=dispatch_override,
        use_pallas=use_pallas, wire_codec=codec, device=str(device))


def init_params(ctx: transformer.ModelCtx, generator, device=None):
    """Fresh parameters from an explicit ``torch.Generator`` (which must
    live on ``device``, default ``ctx.device``).  Every rank draws the
    whole model from the same generator state and keeps its expert shard,
    so replicated tensors agree across ranks and the global model does not
    depend on the world size."""
    return transformer.init_model(ctx, generator, device or ctx.device)


def count_params(params) -> int:
    n = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        else:
            n += node.numel()
    return n
