"""Top-level model API: context building and parameter init (the
counterpart of ``repro/models/model.py``: ``make_ep_spec``, ``make_plan``,
``make_gate_cfg``, ``build_ctx``, ``init_params``).

``mesh`` is the EP world of this rank (``launch.mesh.EPWorld``) or None
for one rank: its axes play the part of the reference's mesh hierarchy
axes (there is no tensor-parallel ``model`` axis in the port yet).
Parameters are this rank's: replicated tensors whole, expert tensors the
rank's shard of the expert axis.  ``build_ctx`` takes the reference's
keywords.  ``abstract_params`` and ``input_specs`` give the dry-run
(``launch/dryrun.py``) this rank's parameters and inputs as tensors on
the ``meta`` device: shapes and dtypes, no storage.
"""

from __future__ import annotations

import math

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig
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
                       links: dict | None = None, wire_codec=None) -> int:
    """Chunk count of the pipelined dispatch; 0 picks it with the overlap
    model (``comm_model``, the reference's link and peak constants, or the
    measured ``links`` of ``comm_model.measured_ep_links``).
    ``wire_codec`` rescales the exchange bytes to the wire encoding, so a
    codec swap can change the verdict."""
    if num_chunks > 0:
        return int(num_chunks)
    terms = comm_model.moe_overlap_terms(
        plan, d_model=arch.d_model, d_ff=arch.moe.d_ff_expert,
        bytes_per_el=2 if arch.torch_dtype == torch.bfloat16 else 4,
        activation=arch.activation, links=links, codec=wire_codec)
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
    model's pick, on links timed on ``mesh`` when ``measured_comm``; a
    collective then, called by every rank) sets the chunk count and the
    plan's capacities round up to a multiple of it.  ``remat`` recomputes
    each layer's forward in the backward.  ``resilience`` is accepted as
    the reference's is and read by nothing here: the training loop takes
    it from ``RunConfig``.  ``device`` is where parameters and caches
    live."""
    if aux_mode not in ("lb", "ta", "hir", "none"):
        raise ValueError(f"unknown aux_mode {aux_mode!r}")
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
        links = None
        if measured_comm and a2a_num_chunks <= 0:
            links = comm_model.measured_ep_links(mesh, ep.axis_names)
        num_chunks = resolve_num_chunks(arch, plan, a2a_num_chunks,
                                        links=links, wire_codec=codec)
        plan = capacity.align_to_chunks(plan, num_chunks)
    return transformer.ModelCtx(
        arch=arch, mesh=mesh, ep=ep, plan=plan, gate_cfg=gate_cfg,
        remat=remat, use_flash=use_flash, use_moe_kernel=use_moe_kernel,
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


class _NoDraw(TorchFunctionMode):
    """Random draws become empty meta tensors of their shape and dtype:
    the initializers' shapes without a draw (a generator cannot draw into
    meta tensors)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.randn:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
            return torch.empty(*args, **kwargs)
        return func(*args, **kwargs)


def abstract_params(ctx: transformer.ModelCtx):
    """This rank's parameter tree on the ``meta`` device: the shapes and
    dtypes :func:`init_params` gives, its expert shard included, with no
    allocation and no draw (the dry-run's parameters)."""
    with _NoDraw():
        return transformer.init_model(ctx, None, "meta")


def batch_rows(B: int, world) -> tuple:
    """``(rows a rank, replicated)``: the global batch sharded over the
    world's ranks, or whole on every rank when it has fewer rows than
    ranks (the reference's context-parallel case, where the port keeps
    the whole batch and cache on every rank)."""
    n = 1 if world is None else world.size
    if B < n:
        return B, True
    if B % n:
        raise ValueError(f"global batch {B} does not divide over {n} ranks")
    return B // n, False


def input_specs(arch: ArchConfig, shape_name, world=None,
                ctx: transformer.ModelCtx | None = None) -> dict:
    """Meta tensors of every model input of one of ``INPUT_SHAPES`` (or
    a dict of its form) at this rank's shapes: ``tokens``/``labels``
    (int32) and ``loss_mask`` for ``train``, ``tokens`` for ``prefill``,
    one token a row and the cache (:func:`decode.init_cache` at the
    shape's length, which needs ``ctx``) for ``decode``; the frontend
    embeddings of an audio or vision model."""
    from repro_torch.models import decode as decode_lib
    sh = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
          else shape_name)
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    rows, _ = batch_rows(B, world)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {}
    if kind == "decode":
        if ctx is None:
            raise ValueError("decode specs need the model ctx (the cache)")
        specs["tokens"] = meta((rows, 1), torch.int32)
        specs["cache"] = decode_lib.init_cache(ctx, rows, S, device="meta")
        return specs
    specs["tokens"] = meta((rows, S), torch.int32)
    if kind == "train":
        specs["labels"] = meta((rows, S), torch.int32)
        specs["loss_mask"] = meta((rows, S), torch.float32)
    if arch.frontend == "vision":
        from repro_torch.models import vlm
        specs["frontend"] = meta(vlm.patch_shape(rows, arch), torch.float32)
    elif arch.frontend:
        from repro_torch.models import whisper
        specs["frontend"] = meta(whisper.frame_shape(rows, arch),
                                 torch.float32)
    return specs
