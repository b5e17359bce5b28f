"""Shared MoE building blocks (the counterpart of
``repro/core/dispatch/base.py``): the expert-parallel spec, the MoE layer
config, parameter init and the expert FFNs.

Single device in this slice: ``EPSpec`` is the unit spec, and the
model-axis reductions of the reference are identities.  Only the raw and
``bf16`` cast wire codecs exist; the scaled int8/fp8 codecs come with the
staged all-to-all path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import gating


@dataclasses.dataclass(frozen=True)
class EPSpec:
    """How expert parallelism maps onto the device mesh: ``hierarchy`` is
    ordered ``(axis_name, size)`` pairs, outermost-first.  The default is
    the single-device spec, one ``data`` axis of size 1."""
    hierarchy: tuple = (("data", 1),)
    model_axis: str | None = None

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
class CastCodec:
    """Cast-only wire codec: payloads travel in ``dtype``."""
    name: str
    dtype: torch.dtype
    quantize_compute: bool = False


CODECS = {"bf16": CastCodec("bf16", torch.bfloat16)}
_UNPORTED_CODECS = ("int8", "fp8e4m3")


def resolve_codec(codec) -> CastCodec | None:
    """``""``/None -> raw model-dtype wire; a registered name or codec."""
    if codec is None or codec == "":
        return None
    if isinstance(codec, CastCodec):
        return codec
    if codec in CODECS:
        return CODECS[codec]
    if codec in _UNPORTED_CODECS:
        raise NotImplementedError(f"wire codec {codec!r} (scaled payloads) "
                                  f"is not ported yet")
    raise ValueError(f"unknown wire codec {codec!r}; registered: "
                     f"{sorted(CODECS)}")


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
    wire_codec: object = None

    def __post_init__(self):
        object.__setattr__(self, "wire_codec", resolve_codec(self.wire_codec))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


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
                    slot_to_token=None, slot_w=None):
    """Segment-offset grouped expert FFN, fused form only in this slice:
    with ``slot_to_token`` / ``slot_w`` given, ``x_flat`` is the raw [T, d]
    token buffer and dispatch gather, expert FFN and gate-weighted combine
    run as one ``moe_fused.local_moe`` call returning the [T, d] float32
    combined output."""
    if slot_to_token is None:
        raise NotImplementedError(
            "expert_ffn_flat over a delivered slot buffer needs the ragged "
            "grouped FFN kernel (staged a2a path), not ported yet")
    from repro_torch.kernels.moe_fused import ops as moe_fused_ops
    if seg_experts is None:
        seg_experts = tuple(range(len(seg_offsets) - 1))
    return moe_fused_ops.local_moe(
        x_flat, slot_to_token, slot_w, seg_offsets, seg_experts, rows_valid,
        params["w_in"], params.get("w_gate"), params["w_out"],
        activation=cfg.activation, use_pallas=use_pallas)


def shared_ffn(params, x, cfg: MoEConfig, ep: EPSpec):
    if cfg.activation == "swiglu":
        h = F.silu(x @ params["shared_gate"]) * (x @ params["shared_in"])
    else:
        h = F.gelu(x @ params["shared_in"], approximate="tanh")
    return h @ params["shared_out"]
