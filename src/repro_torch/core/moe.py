"""Deprecated compatibility shim over :mod:`repro_torch.core.dispatch` (the
counterpart of ``repro/core/moe.py``).

The MoE layer used to live here as four hand-rolled dispatch functions;
it is now the composable ``core/dispatch`` package (routing / transport /
schedule / engine).  This module keeps the old import surface working —
``MoEConfig``, ``EPSpec``, parameter init, the expert FFNs, the
``software_pipeline`` skeleton, and ``moe_apply_*`` wrappers that resolve
through the :class:`~repro_torch.core.dispatch.engine.DispatchEngine`
registry.  The reference's ``moe_param_specs`` has no counterpart here:
the port's specs come from ``models.model.param_specs``.

New code should call ``repro_torch.core.dispatch.engine`` directly (or go
through ``models/transformer._moe_block``, which already does); each
``moe_apply_*`` wrapper emits a ``DeprecationWarning`` on use.  Every path
returns the uniform metrics dict ``("aux_loss", "frac_by_level",
"frac_near", "frac_far", "dropped")``: ``frac_by_level`` is the
level-indexed vector, ``frac_near`` / ``frac_far`` its deprecated 2-level
aliases.  Where the reference runs inside ``shard_map``, the port's
wrappers take the EP world as ``world=`` (None: one rank).
"""

from __future__ import annotations

import warnings

from repro_torch.core.dispatch import engine as _engine
from repro_torch.core.dispatch.base import (  # noqa: F401  (re-exports)
    EPSpec,
    MoEConfig,
    expert_ffn,
    init_moe_params,
    shared_ffn,
)
from repro_torch.core.dispatch.base import _act  # noqa: F401  (legacy name)
from repro_torch.core.dispatch.routing import (  # noqa: F401  (legacy names)
    pad_selection as _pad_selection,
    route as _route,
    score_matrix as _score_matrix,
    select as _select,
)
from repro_torch.core.dispatch.schedule import software_pipeline  # noqa: F401
from repro_torch.core.dispatch.transport import wire_a2a as _a2a  # noqa: F401


def _deprecated(wrapper: str, path: str):
    warnings.warn(
        f"repro_torch.core.moe.{wrapper} is deprecated; use "
        f"repro_torch.core.dispatch.engine.dispatch_moe({path!r}, ...) or "
        f"make_engine instead", DeprecationWarning, stacklevel=3)


def moe_apply_a2a(params, x, cfg, ep, plan, gate_cfg, world=None):
    """x: [T_local, d] on this EP rank. Returns (y, metrics)."""
    _deprecated("moe_apply_a2a", "a2a")
    return _engine.dispatch_moe("a2a", params, x, cfg=cfg, ep=ep,
                                gate_cfg=gate_cfg, plan=plan, world=world)


def moe_apply_a2a_pipelined(params, x, cfg, ep, plan, gate_cfg,
                            num_chunks: int = 2, world=None):
    """Chunked, software-pipelined variant of :func:`moe_apply_a2a`."""
    _deprecated("moe_apply_a2a_pipelined", "a2a_pipelined")
    return _engine.dispatch_moe("a2a_pipelined", params, x, cfg=cfg, ep=ep,
                                gate_cfg=gate_cfg, plan=plan,
                                num_chunks=num_chunks, world=world)


def moe_apply_gather(params, x, cfg, ep, gate_cfg,
                     tokens_replicated: bool = False, world=None):
    """Decode-time MoE: weights stationary, tokens gathered."""
    _deprecated("moe_apply_gather", "gather")
    return _engine.dispatch_moe("gather", params, x, cfg=cfg, ep=ep,
                                gate_cfg=gate_cfg,
                                tokens_replicated=tokens_replicated,
                                world=world)


def moe_apply_einsum(params, x, cfg, ep, gate_cfg,
                     capacity: int | None = None, world=None):
    """GShard/DeepSpeed einsum baseline (paper §2)."""
    _deprecated("moe_apply_einsum", "einsum")
    return _engine.dispatch_moe("einsum", params, x, cfg=cfg, ep=ep,
                                gate_cfg=gate_cfg, capacity=capacity,
                                world=world)
