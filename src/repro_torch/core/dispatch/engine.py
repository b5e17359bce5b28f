"""DispatchEngine: the registry of named MoE dispatch paths (the
counterpart of ``repro/core/dispatch/engine.py``).

Every path returns ``(y, metrics)`` with the uniform schema
:data:`METRIC_KEYS`; the engine fills missing keys with neutral defaults.
This slice registers the weights-stationary ``gather`` path — the one
prefill and decode resolve every MoE layer to.  The staged ``a2a`` /
``a2a_pipelined`` paths (with the topology and capacity planning they
need) and the ``einsum`` baseline are not ported yet: resolving them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable

import torch

from repro_torch.core import gating
from repro_torch.core.dispatch import routing, transport
from repro_torch.core.dispatch.base import (EPSpec, MoEConfig, expert_ffn,
                                            expert_ffn_flat, shared_ffn)
from repro_torch.kernels.moe_fused import ops as moe_fused_ops
from repro_torch.kernels.moe_permute.ref import unpermute_ref

METRIC_KEYS = ("aux_loss", "frac_by_level", "frac_near", "frac_far",
               "dropped")

#: paths of the reference registry that this package does not have yet
UNPORTED_PATHS = ("a2a", "a2a_pipelined", "einsum")


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
    """ValueError for names no registry knows; names of paths not ported
    yet pass (a ctx may carry them as its training-time default)."""
    if name not in _REGISTRY and name not in UNPORTED_PATHS:
        raise ValueError(f"unknown dispatch {name!r}; registered paths: "
                         f"{available()}")


def get_path(name: str) -> DispatchPath:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in UNPORTED_PATHS:
            raise NotImplementedError(
                f"dispatch {name!r} is not ported yet (it needs "
                f"core/topology.py, core/capacity.py and the staged a2a "
                f"transport); ported paths: {available()}") from None
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
    tokens_replicated: bool = False
    use_pallas: bool | None = None

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
                tokens_replicated: bool = False,
                use_pallas: bool | None = None) -> DispatchEngine:
    """Resolve ``name`` against the registry and bind the static config."""
    path = get_path(name)
    if path.needs_plan and plan is None:
        raise ValueError(f"dispatch {name!r} requires a DispatchPlan")
    return DispatchEngine(path=path, cfg=cfg, ep=ep, gate_cfg=gate_cfg,
                          plan=plan, tokens_replicated=tokens_replicated,
                          use_pallas=use_pallas)


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
        y = unpermute_ref(y.reshape(E_l * Tg, -1), inv_idx, inv_w)
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
