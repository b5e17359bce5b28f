"""Top-level model API: context building and parameter init (the
counterpart of ``repro/models/model.py``: ``make_ep_spec``,
``make_gate_cfg``, ``build_ctx``, ``init_params``).

Single device in this slice: ``mesh`` is None (or a mesh shape whose
extents are all 1), the EP spec is the unit spec and ``plan`` stays None —
the gather path never reads it, and ``ModelCtx.frac_levels`` falls back to
``ep.num_stages``.  ``build_ctx`` takes the reference's keywords and
raises ``NotImplementedError`` for the options whose code is not ported
yet.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig
from repro_torch.core import gating
from repro_torch.core.dispatch import base as moe_base
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.models import transformer


def _check_single_device(mesh) -> None:
    if mesh is None:
        return
    shape = tuple(mesh.values()) if isinstance(mesh, dict) else tuple(mesh)
    if math.prod(int(s) for s in shape) != 1:
        raise NotImplementedError(
            f"mesh {mesh!r}: multi-device meshes need the torch.distributed "
            f"transport, not ported yet (pass None or an all-ones shape)")


def make_ep_spec(arch: ArchConfig, mesh=None) -> moe_base.EPSpec | None:
    """The EP hierarchy; on one device the unit spec."""
    if not arch.is_moe:
        return None
    _check_single_device(mesh)
    return moe_base.EPSpec()


def make_gate_cfg(arch: ArchConfig, plan, ep, aux_mode: str,
                  ) -> gating.GateConfig | None:
    """Gate config; without a plan every level's penalty is 1 (on one
    device all experts sit at level 0, where the reference's normalized
    Eq. (8) penalty is 1 too)."""
    if not arch.is_moe:
        return None
    if plan is not None:
        raise NotImplementedError("topology-derived penalties need "
                                  "core/capacity.py, not ported yet")
    return gating.GateConfig(
        num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor, aux_mode=aux_mode,
        penalty_by_level=(1.0, 1.0, 1.0))


def build_ctx(arch: ArchConfig, mesh=None, *, seq_len: int = 0,
              global_batch: int = 0, aux_mode: str = "ta",
              remat: bool = False, decode_replicated: bool = False,
              use_flash: bool = False, use_moe_kernel: bool = False,
              dispatch: str = "a2a", a2a_num_chunks: int = 0,
              dispatch_override: tuple = (), measured_comm: bool = False,
              use_pallas=None, wire_codec="", resilience=None,
              device="cuda") -> transformer.ModelCtx:
    """The model context.  ``seq_len`` / ``global_batch`` size the a2a
    capacity plan and ``a2a_num_chunks`` its pipelining in the reference;
    they are unused until that path is ported.  ``device`` is where
    parameters and caches live."""
    if aux_mode not in ("lb", "ta", "hir", "none"):
        raise ValueError(f"unknown aux_mode {aux_mode!r}")
    if remat:
        raise NotImplementedError("remat applies to the training forward, "
                                  "not ported yet")
    if use_moe_kernel:
        raise NotImplementedError("use_moe_kernel (the dense grouped FFN "
                                  "kernel) is not ported yet")
    if measured_comm:
        raise NotImplementedError("measured_comm needs core/comm_model.py, "
                                  "not ported yet")
    if resilience is not None:
        raise NotImplementedError("the resilient runtime is not ported yet")
    codec = moe_base.resolve_codec(wire_codec)
    if arch.is_moe and arch.moe.dispatch_override:
        merged = dict(arch.moe.dispatch_override)
        merged.update(dict(dispatch_override))
        dispatch_override = tuple(sorted(merged.items()))
    else:
        dispatch_override = tuple(sorted(dict(dispatch_override).items()))
    for name in (dispatch,) + tuple(n for _, n in dispatch_override):
        dispatch_lib.check_name(name)
    ep = make_ep_spec(arch, mesh)
    gate_cfg = make_gate_cfg(arch, None, ep, aux_mode)
    return transformer.ModelCtx(
        arch=arch, ep=ep, plan=None, gate_cfg=gate_cfg, use_flash=use_flash,
        decode_replicated=decode_replicated, dispatch=dispatch,
        dispatch_override=dispatch_override,
        use_pallas=use_pallas, wire_codec=codec, device=str(device))


def init_params(ctx: transformer.ModelCtx, generator, device=None):
    """Fresh parameters from an explicit ``torch.Generator`` (which must
    live on ``device``, default ``ctx.device``)."""
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
