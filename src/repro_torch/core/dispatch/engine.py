"""DispatchEngine: the registry of named MoE dispatch paths (the
counterpart of ``repro/core/dispatch/engine.py``).

Every path returns ``(y, metrics)`` with the uniform schema
:data:`METRIC_KEYS`; the engine fills missing keys with neutral defaults.
Registered paths:

    a2a            staged hierarchical all-to-all (training): the
                   software pipeline at num_chunks=1; stages with one
                   destination fuse into the local megakernel (K4), the
                   others run permute (K1) -> all-to-all chain -> ragged
                   grouped FFN (K3, or K7 under the int8 wire) -> reverse
                   chain -> unpermute (K2)
    a2a_pipelined  the same routing and capacities, the capacity axis cut
                   into ``num_chunks`` chunks run through the 3-stage
                   schedule (``model.build_ctx`` picks the count with
                   ``core/comm_model.py``)
    gather         weights-stationary path of prefill and decode (one rank)
    einsum         the GShard one-hot [T, N, C] baseline, shard-local: the
                   equivalence oracle of the tests

An engine runs on one EP rank with its local expert shard; ``world``
(``launch.mesh.EPWorld``, None for the unit world) gives the rank's
coordinates and the collectives.  Eager PyTorch issues the collectives in
program order, so the pipelined schedule does not overlap a chunk's
exchange with another's compute yet.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import gating
from repro_torch.core.dispatch import routing, schedule, transport
from repro_torch.core.dispatch.base import (EPSpec, MoEConfig, expert_ffn,
                                            expert_ffn_flat, shared_ffn)
from repro_torch.core.dispatch.routing import _prod
from repro_torch.kernels.moe_fused import ops as moe_fused_ops
from repro_torch.kernels.moe_gemm import ops as moe_gemm_ops
from repro_torch.kernels.moe_permute import ops as permute_ops

METRIC_KEYS = ("aux_loss", "frac_by_level", "frac_near", "frac_far",
               "dropped")

@dataclasses.dataclass(frozen=True)
class DispatchPath:
    name: str
    fn: Callable
    needs_plan: bool = False


_REGISTRY: dict = {}


def register(name: str, *, needs_plan: bool = False):
    """Decorator registering ``fn(params, x, eng) -> (y, metrics)``."""
    def deco(fn):
        _REGISTRY[name] = DispatchPath(name=name, fn=fn, needs_plan=needs_plan)
        return fn
    return deco


def available() -> tuple:
    return tuple(sorted(_REGISTRY))


def check_name(name: str) -> None:
    """ValueError for names the registry does not know."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown dispatch {name!r}; registered paths: "
                         f"{available()}")


def get_path(name: str) -> DispatchPath:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown dispatch {name!r}; registered paths: "
                         f"{available()}") from None


@dataclasses.dataclass(frozen=True)
class DispatchEngine:
    """A dispatch path resolved against one MoE layer's static config;
    callable on ``(params, x)`` with ``x: [T, d]``."""

    path: DispatchPath
    cfg: MoEConfig
    ep: EPSpec
    gate_cfg: gating.GateConfig
    plan: object | None = None
    num_chunks: int = 1               # a2a_pipelined schedule depth
    capacity: int | None = None       # einsum buffer capacity (None = cf rule)
    tokens_replicated: bool = False
    use_pallas: bool | None = None
    world: object | None = None       # launch.mesh.EPWorld; None = unit

    @property
    def name(self) -> str:
        return self.path.name

    @property
    def num_stages(self) -> int:
        return self.plan.num_stages if self.plan is not None \
            else self.ep.num_stages

    def __call__(self, params, x):
        y, metrics = self.path.fn(params, x, self)
        fb = metrics.get("frac_by_level")
        if fb is None:
            fb = torch.zeros((self.num_stages,), dtype=torch.float32,
                             device=x.device)
            fb[0] = 1.0
        dropped = metrics.get("dropped", 0.0)
        if not torch.is_tensor(dropped):
            dropped = _constant(float(dropped), x.device)
        out = {"aux_loss": metrics["aux_loss"],
               "frac_by_level": fb.to(torch.float32),
               "frac_near": fb[0],
               "frac_far": 1.0 - fb[0],
               "dropped": dropped.to(torch.float32)}
        return y, out


@functools.lru_cache(maxsize=None)
def _constant(value: float, device) -> torch.Tensor:
    """A read-only float32 scalar on ``device``, made once: a path's
    constant metric then costs no launch and no host copy per call."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def make_engine(name: str, *, cfg: MoEConfig, ep: EPSpec,
                gate_cfg: gating.GateConfig, plan=None,
                num_chunks: int = 1, capacity: int | None = None,
                tokens_replicated: bool = False,
                use_pallas: bool | None = None,
                world=None) -> DispatchEngine:
    """Resolve ``name`` against the registry and bind the static config."""
    path = get_path(name)
    if path.needs_plan and plan is None:
        raise ValueError(f"dispatch {name!r} requires a DispatchPlan")
    return DispatchEngine(path=path, cfg=cfg, ep=ep, gate_cfg=gate_cfg,
                          plan=plan, num_chunks=max(1, int(num_chunks)),
                          capacity=capacity,
                          tokens_replicated=tokens_replicated,
                          use_pallas=use_pallas, world=world)


def _world(eng: DispatchEngine, device):
    if eng.world is not None:
        return eng.world
    from repro_torch.launch.mesh import unit_world
    if eng.ep.ep_world != 1:
        raise ValueError(f"an EP spec over {eng.ep.ep_world} ranks needs the "
                         f"EP world (launch.mesh.make_hierarchical_mesh)")
    return unit_world(device)


# ---------------------------------------------------------------------------
# staged a2a paths (sync == num_chunks 1, pipelined == num_chunks k)
# ---------------------------------------------------------------------------


def local_layout(local_work, topk_idx, T: int, num_experts: int):
    """Slot maps and segments of the stages that deliver to this rank only
    (``local_work``: ``(stage, selection)`` pairs with ``num_dests == 1``),
    which run as one fused ``local_moe`` call.  Returns ``(indices,
    seg_offsets, seg_experts)``: one segment per (stage, expert), stage
    major, as wide as the stage's capacity."""
    li = routing.build_indices(
        tuple((stage.index, sel) for stage, sel in local_work), topk_idx, T)
    offs, exps = [0], []
    for _stage, sel in local_work:
        width = sel.idx.shape[-1]
        for e in range(num_experts):
            offs.append(offs[-1] + width)
            exps.append(e)
    return li, tuple(offs), tuple(exps)


def _staged_a2a(params, x, eng: DispatchEngine, num_chunks: int):
    """The staged implementation behind ``a2a`` and ``a2a_pipelined``:
    shared routing, the shared sort-based buffer builder
    (``routing.build_indices`` + the moe_permute entries), chunk-sliced
    stage-list transport and the software pipeline.

    Stages whose delivery chain is the identity (``num_dests == 1``: the
    folded-in self level of a unit axis, so every stage on one rank) run
    as one fused ``moe_fused.local_moe`` call when the kernel branch is
    wanted; the others dispatch through permute -> all-to-all chain ->
    grouped FFN -> reverse chain -> unpermute.  A (token, expert) pair
    holds at most one slot globally, so the local and remote outputs add.
    With the kernel branch wanted, the per-(destination, expert) valid-row
    counts ride each remote stage's chain (``dispatch_counts``) and the
    expert compute goes through the occupancy-aware ragged entry.  A wire
    codec with ``quantize_compute`` (int8) sends the remote stages' expert
    compute through the int8 ragged entry (K7).
    """
    cfg, ep, plan, gate_cfg = eng.cfg, eng.ep, eng.plan, eng.gate_cfg
    T, d = x.shape
    world = _world(eng, x.device)
    tr = transport.A2ATransport(ep=ep, world=world, codec=cfg.wire_codec)
    stages = transport.plan_stages(plan, ep)
    quant = cfg.wire_codec is not None and cfg.wire_codec.quantize_compute

    routed = routing.route(params, x, cfg, ep, plan, gate_cfg, world.coords)
    kept_unpadded = sum(sel.valid.sum() for _, sel in routed.sels)
    num_chunks = max(1, int(num_chunks))
    topk_idx = routed.gate_out["topk_idx"]

    # split the active stages: purely local delivery fuses, the rest keep
    # the staged transport.  Per remote stage: (transport stage, padded
    # selection, capacity axis, per-chunk capacity, expert rows per chunk)
    fused_on = moe_fused_ops.use_fused(eng.use_pallas, x.device)
    local_work, work = [], []
    for (s, sel), stage in zip(routed.sels, stages):
        if fused_on and stage.num_dests == 1:
            local_work.append((stage, sel))
            continue
        cap_axis = s + 2
        sel = routing.pad_selection(sel, axis=cap_axis, multiple=num_chunks)
        cpc = sel.idx.shape[cap_axis] // num_chunks
        work.append((stage, sel, cap_axis, cpc, stage.num_dests * cpc))

    out_local = None
    if local_work:
        li, offs, exps = local_layout(local_work, topk_idx, T,
                                      params["w_in"].shape[0])
        out_local = expert_ffn_flat(
            params, x, offs, cfg, ep, seg_experts=exps,
            rows_valid=li.rows_per_expert, slot_to_token=li.slot_to_token,
            slot_w=li.slot_w, use_pallas=eng.use_pallas)        # [T, d] f32

    # chunk j's capacity slice of every remote stage, flattened into one
    # sort-order index set (sync == chunk 0)
    indices = [routing.build_indices(
        tuple((stage.index,
               routing.slice_selection(sel, cap_axis, j * cpc, cpc))
              for stage, sel, cap_axis, cpc, _ in work),
        topk_idx, T) for j in range(num_chunks)] if work else []
    ragged = moe_gemm_ops.use_ragged(eng.use_pallas, x.device)

    def dispatch(j):
        di = indices[j]
        flat = permute_ops.permute(x, di.slot_to_token,
                                   use_pallas=eng.use_pallas)      # [S_j, d]
        parts, cnts = [], None
        for (stage, *_), (_, off, shape) in zip(work, di.stage_spans()):
            buf = flat[off:off + _prod(shape)]
            parts.append(tr.dispatch(buf.reshape(shape + (d,)), stage))
        if ragged:
            cnts = tuple(
                tr.dispatch_counts(
                    di.rows_per_expert[off:off + _prod(shape)].reshape(shape),
                    stage)
                for (stage, *_), (_, off, shape) in zip(work,
                                                        di.expert_spans()))
        xin = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return xin, cnts

    def compute(j, v):
        xin, cnts = v
        E_l, R, _ = xin.shape
        if cnts is None:
            segs, exps, valid = transport.expert_segments(E_l, R), None, None
        else:
            segs, exps = transport.stage_segments(
                E_l, tuple((stage.num_dests, cpc)
                           for stage, _, _, cpc, _ in work))
            valid = (torch.cat(cnts, dim=1) if len(cnts) > 1
                     else cnts[0]).reshape(-1).contiguous()
        # The reference pads chunk slices to 128-row kernel blocks
        # (chunk_granular); the port's kernels mask any segment width inside
        # 64-row tiles, so chunk slices need no padding here.
        y = expert_ffn_flat(params, xin.reshape(E_l * R, d), segs, cfg, ep,
                            seg_experts=exps, rows_valid=valid,
                            use_pallas=eng.use_pallas, quantized=quant)
        return y.reshape(E_l, R, d)

    def combine(out, j, y_exp):
        if out is None:
            out = torch.zeros((T, d), dtype=y_exp.dtype, device=x.device)
        di = indices[j]
        flats, off = [], 0
        for stage, _, _, _, rows in work:
            back = tr.combine(y_exp[:, off:off + rows], stage)
            off += rows
            flats.append(back.reshape(-1, d))
        y_flat = flats[0] if len(flats) == 1 else torch.cat(flats, 0)
        mixed = permute_ops.unpermute(y_flat.contiguous(), di.inv_idx,
                                      di.inv_w, use_pallas=eng.use_pallas)
        return out + mixed.to(out.dtype)

    if work:
        out = schedule.software_pipeline(num_chunks, dispatch, compute,
                                         combine, None)
    else:
        out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    if out_local is not None:
        out = out + out_local.to(out.dtype)
    if cfg.num_shared_experts:
        out = out + shared_ffn(params, x, cfg, ep).to(out.dtype)

    frac = gating.dispatch_fractions(topk_idx, cfg.num_experts)
    metrics = {
        "aux_loss": routed.aux,
        "frac_by_level": gating.frac_by_level(frac, routed.levels,
                                              plan.num_stages),
        "dropped": 1.0 - torch.clamp(
            kept_unpadded / (T * gate_cfg.top_k), max=1.0),
    }
    return out.to(x.dtype), metrics


@register("a2a", needs_plan=True)
def _a2a_path(params, x, eng: DispatchEngine):
    """Sync staged all-to-all: the pipeline schedule at num_chunks=1."""
    return _staged_a2a(params, x, eng, 1)


@register("a2a_pipelined", needs_plan=True)
def _a2a_pipelined_path(params, x, eng: DispatchEngine):
    """The chunked schedule over the same routing."""
    return _staged_a2a(params, x, eng, eng.num_chunks)


# ---------------------------------------------------------------------------
# gather path (decode and fused prefill)
# ---------------------------------------------------------------------------


@register("gather")
def _gather_path(params, x, eng: DispatchEngine):
    """Weights stationary, tokens gathered.  x: [T, d].

    Fused branch (kernels wanted): the dense [E_l, Tg] slot space maps
    token ``t`` through expert ``e`` at slot ``e * Tg + t``; one
    ``local_moe`` call gathers, runs the FFN and scatter-adds with the gate
    weights, and an expert picked by no token is a skipped zero-valid
    segment.  Unfused branch: broadcast the tokens to every expert, run
    the plain grouped FFN, and combine through the weighted inverse
    permutation.
    """
    cfg, ep, gate_cfg = eng.cfg, eng.ep, eng.gate_cfg
    E_l = max(1, -(-cfg.num_experts // ep.ep_world))
    tr = transport.GatherTransport(ep=ep,
                                   tokens_replicated=eng.tokens_replicated)
    coords = (0,) * ep.num_stages
    my_rank = 0

    xg = tr.gather(x)
    levels = gating.expert_levels_nd(cfg.num_experts, E_l, ep.axis_sizes,
                                     coords, device=x.device)
    gate_out = gating.gate_forward(params["gate"], xg, gate_cfg, None)
    aux = gating.aux_loss(gate_out, gate_cfg, levels)

    Tg, d = xg.shape
    if moe_fused_ops.use_fused(eng.use_pallas, x.device):
        slot_tok, slot_w, valid = routing.gather_slots(gate_out, my_rank,
                                                       E_l)
        y = expert_ffn_flat(params, xg, transport.expert_segments(E_l, Tg),
                            cfg, ep, seg_experts=tuple(range(E_l)),
                            rows_valid=valid, slot_to_token=slot_tok,
                            slot_w=slot_w, use_pallas=eng.use_pallas)
    else:
        xin = xg.expand(E_l, Tg, d)                              # [E_l, Tg, d]
        y = expert_ffn(params, xin, cfg, ep)
        inv_idx, inv_w = routing.gather_inverse(gate_out, my_rank, E_l, Tg)
        y = permute_ops.unpermute(y.reshape(E_l * Tg, -1), inv_idx, inv_w,
                                  use_pallas=eng.use_pallas)
    y = y.to(x.dtype)

    y = tr.reduce(y)
    y = tr.slice_local(y, my_rank, x.shape[0])

    if cfg.num_shared_experts:
        y = y + shared_ffn(params, x, cfg, ep).to(y.dtype)

    frac = gating.dispatch_fractions(gate_out["topk_idx"], cfg.num_experts)
    metrics = {"aux_loss": aux,
               "frac_by_level": gating.frac_by_level(frac, levels,
                                                     eng.num_stages),
               "dropped": 0.0}
    return y.to(x.dtype), metrics


# ---------------------------------------------------------------------------
# GShard/DeepSpeed-style einsum dispatch (the paper's §2 baseline)
# ---------------------------------------------------------------------------


@register("einsum")
def _einsum_path(params, x, eng: DispatchEngine):
    """One-hot dispatch/combine tensors of shape [T, N, C] route tokens
    through a zero-padded [N, C, d] buffer.  Shard-local (no collectives):
    single-rank only, the equivalence oracle of the selection-based paths.
    """
    cfg, ep, gate_cfg = eng.cfg, eng.ep, eng.gate_cfg
    T, d = x.shape
    N, K = cfg.num_experts, cfg.top_k
    capacity = eng.capacity
    if capacity is None:
        capacity = max(1, int(T * K * cfg.capacity_factor / N))
    dev = x.device

    gate_out = gating.gate_forward(params["gate"], x, gate_cfg, None)
    aux = gating.aux_loss(gate_out, gate_cfg, None)
    topk_idx, topk_w = gate_out["topk_idx"], gate_out["topk_weight"]

    dispatch = torch.zeros((T, N, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((T, N, capacity), dtype=torch.float32, device=dev)
    counts = torch.zeros((N,), dtype=torch.int64, device=dev)
    slots = torch.arange(capacity, device=dev)
    for s in range(K):
        e = topk_idx[:, s].long()                              # [T]
        onehot = F.one_hot(e, N)                               # [T, N]
        pos_in_e = (torch.cumsum(onehot, dim=0) - 1) * onehot
        pos = pos_in_e.sum(dim=1) + counts[e]                  # [T]
        keep = pos < capacity
        slot = (pos[:, None] == slots[None, :]).to(torch.float32)
        mask = onehot.to(torch.float32) * keep[:, None].to(torch.float32)
        d_s = mask[:, :, None] * slot[:, None, :]              # [T, N, C]
        dispatch = dispatch + d_s
        combine = combine + d_s * topk_w[:, s].to(torch.float32)[:, None,
                                                                 None]
        counts = counts + torch.sum(onehot * keep[:, None], dim=0)

    xin = torch.einsum("tnc,td->ncd", dispatch, x.to(torch.float32))
    y_exp = expert_ffn(params, xin.to(x.dtype), cfg, ep)       # [N, C, d]
    y = torch.einsum("tnc,ncd->td", combine, y_exp.to(torch.float32))
    if cfg.num_shared_experts:
        y = y + shared_ffn(params, x, cfg, ep).to(y.dtype)
    metrics = {"aux_loss": aux,
               "dropped": 1.0 - dispatch.sum() / (T * K)}
    return y.to(x.dtype), metrics
