"""Shared MoE building blocks (the counterpart of
``repro/core/dispatch/base.py``): the expert-parallel spec, the MoE layer
config, parameter init and the expert FFNs.

Everything here runs on one EP rank with its local expert shard.  There
is no tensor-parallel ``model`` axis in the port yet, so the reference's
model-axis reductions are identities.  ``MoEConfig.wire_codec`` resolves
through ``core.dispatch.wire``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import gating
from repro_torch.core.dispatch import wire


@dataclasses.dataclass(frozen=True)
class EPSpec:
    """How expert parallelism maps onto the device mesh: ``hierarchy`` is
    ordered ``(axis_name, size)`` pairs, outermost-first.  The default is
    the single-device spec, one ``data`` axis of size 1."""
    hierarchy: tuple = (("data", 1),)
    model_axis: str | None = None

    @classmethod
    def from_axes(cls, axis_names, axis_sizes, model_axis=None) -> EPSpec:
        names = tuple(axis_names)
        sizes = tuple(int(s) for s in axis_sizes)
        if len(names) != len(sizes) or not names:
            raise ValueError(f"axis names {names} do not fit sizes {sizes}")
        return cls(hierarchy=tuple(zip(names, sizes)), model_axis=model_axis)

    @property
    def axis_names(self) -> tuple:
        return tuple(n for n, _ in self.hierarchy)

    @property
    def axis_sizes(self) -> tuple:
        return tuple(s for _, s in self.hierarchy)

    @property
    def num_stages(self) -> int:
        return len(self.hierarchy)

    @property
    def ep_world(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                     # per-expert intermediate size
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    activation: str = "swiglu"    # "swiglu" | "gelu"
    dtype: torch.dtype = torch.bfloat16
    use_kernel: bool = False      # the dense grouped FFN kernel (K6)
    wire_codec: object = None

    def __post_init__(self):
        if self.use_kernel:
            raise NotImplementedError(
                "MoEConfig.use_kernel needs the dense grouped FFN kernel "
                "(K6, moe_gemm/kernel.py:185), not ported yet")
        object.__setattr__(self, "wire_codec",
                           wire.get_codec(self.wire_codec))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

#: the MoE layer's tensors that carry the expert axis (axis 0), sharded
#: over the EP ranks; every other tensor of the layer is replicated
EXPERT_PARAMS = ("w_in", "w_gate", "w_out")


def init_moe_params(cfg: MoEConfig, ep: EPSpec, gate_cfg: gating.GateConfig,
                    generator, device="cuda"):
    """Parameter dict of one MoE layer; expert tensors carry all N experts
    on axis 0."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_experts
    s1, s2 = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(cfg.dtype)

    p = {"gate": gating.init_gate_params(d, gate_cfg, generator, device),
         "w_in": normal((n, d, f), s1),
         "w_out": normal((n, f, d), s2)}
    if cfg.activation == "swiglu":
        p["w_gate"] = normal((n, d, f), s1)
    if cfg.num_shared_experts:
        fs = cfg.d_ff * cfg.num_shared_experts
        p["shared_in"] = normal((d, fs), s1)
        p["shared_out"] = normal((fs, d), s2)
        if cfg.activation == "swiglu":
            p["shared_gate"] = normal((d, fs), s1)
    return p


# ---------------------------------------------------------------------------
# expert FFN
# ---------------------------------------------------------------------------


def _act(cfg: MoEConfig, xin, params):
    if cfg.activation == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", xin, params["w_gate"]))
        return h * torch.einsum("ecd,edf->ecf", xin, params["w_in"])
    return F.gelu(torch.einsum("ecd,edf->ecf", xin, params["w_in"]),
                  approximate="tanh")


def expert_ffn(params, xin, cfg: MoEConfig, ep: EPSpec):
    """Grouped expert FFN on [E_local, C, d] -> [E_local, C, d] in the
    model dtype (plain tensor products)."""
    h = _act(cfg, xin, params)
    return torch.einsum("ecf,efd->ecd", h, params["w_out"])


def expert_ffn_flat(params, x_flat, seg_offsets, cfg: MoEConfig, ep: EPSpec,
                    *, seg_experts=None, rows_valid=None, use_pallas=None,
                    slot_to_token=None, slot_w=None, quantized: bool = False):
    """Segment-offset grouped expert FFN on a flat [R, d] row buffer.

    ``seg_offsets`` is the static offset vector of the contiguous sorted
    spans the dispatch delivers; ``seg_experts`` names each segment's
    expert (default: one segment per expert, in order) and ``rows_valid``
    optionally carries the runtime realized-row count per segment.

    Fused mode: with ``slot_to_token`` / ``slot_w`` given, ``x_flat`` is
    the raw [T, d] token buffer and dispatch gather, expert FFN and
    gate-weighted combine run as one ``moe_fused.local_moe`` call returning
    the [T, d] float32 combined output.

    ``quantized=True`` (set by the engine when the wire codec opts
    delivered rows into low-precision compute) routes every non-fused call
    through the int8 ragged entry (K7), whatever the kernel policy; its
    backward is full precision (straight-through).

    Otherwise, with the kernel branch wanted (``moe_gemm.ops.use_ragged``)
    the call goes through the occupancy-aware ragged entry; with it off the
    (contiguous, expert-major) segments collapse to per-expert spans — the
    zero-filled slack rows make the dense compute equal the masked one —
    and equal spans run as one dense product, as in the reference.
    """
    from repro_torch.kernels.moe_gemm import ops as moe_gemm_ops
    offs = tuple(int(o) for o in seg_offsets)
    d = x_flat.shape[-1]
    if slot_to_token is not None:
        from repro_torch.kernels.moe_fused import ops as moe_fused_ops
        if seg_experts is None:
            seg_experts = tuple(range(len(offs) - 1))
        return moe_fused_ops.local_moe(
            x_flat, slot_to_token, slot_w, offs, seg_experts, rows_valid,
            params["w_in"], params.get("w_gate"), params["w_out"],
            activation=cfg.activation, use_pallas=use_pallas)
    if quantized or moe_gemm_ops.use_ragged(use_pallas, x_flat.device):
        return moe_gemm_ops.grouped_ffn_segments(
            x_flat, offs, params["w_in"], params.get("w_gate"),
            params["w_out"], activation=cfg.activation,
            seg_experts=seg_experts, rows_valid=rows_valid,
            use_pallas=use_pallas, quantized=quantized)
    if seg_experts is None:
        per_expert = offs
    else:
        if tuple(seg_experts) != tuple(sorted(seg_experts)):
            raise ValueError("segments must be expert-major for the plain "
                             "path")
        E = params["w_in"].shape[0]
        per_expert = [0] * (E + 1)
        for s, e in enumerate(seg_experts):
            per_expert[e + 1] = offs[s + 1]
        for e in range(E):                     # experts with no segments
            per_expert[e + 1] = max(per_expert[e + 1], per_expert[e])
        per_expert = tuple(per_expert)
    E = len(per_expert) - 1
    widths = {per_expert[e + 1] - per_expert[e] for e in range(E)}
    if len(widths) == 1:
        xg = x_flat.reshape(E, per_expert[1] - per_expert[0], d)
        h = _act(cfg, xg, params)
        return torch.einsum("ecf,efd->ecd", h, params["w_out"]).reshape(-1, d)
    return moe_gemm_ops.grouped_ffn_ragged(
        x_flat, per_expert, tuple(range(E)), None, params["w_in"],
        params.get("w_gate"), params["w_out"], activation=cfg.activation,
        use_pallas=False)


def shared_ffn(params, x, cfg: MoEConfig, ep: EPSpec):
    if cfg.activation == "swiglu":
        h = F.silu(x @ params["shared_gate"]) * (x @ params["shared_in"])
    else:
        h = F.gelu(x @ params["shared_in"], approximate="tanh")
    return h @ params["shared_out"]
