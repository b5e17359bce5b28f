"""Decoder assembly for the attention + MoE family (the counterpart of
``repro/models/transformer.py``: ``SubLayer``, ``ModelCtx``,
``layer_plan``, ``init_model`` and ``_moe_block``).

The reference stacks the repeated layer group and runs it with
``lax.scan``; here parameters are a Python list of per-layer dicts
(``params["layers"]``) walked by a Python loop.  ``transformer.forward``
and ``loss_fn`` (the a2a training path) come with the training slice.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core import gating
from repro_torch.core.dispatch import base as moe_base
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str                    # attn (mla | mamba | mlstm | slstm: later)
    ffn: str | None               # mlp | moe | None
    cross: bool = False
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Everything the forward pass needs besides params and data."""
    arch: ArchConfig
    ep: moe_base.EPSpec | None = None
    plan: object | None = None        # level-indexed a2a capacities (later)
    gate_cfg: gating.GateConfig | None = None
    use_flash: bool = False
    decode_replicated: bool = False
    dispatch: str = "a2a"             # training-time default path
    dispatch_override: tuple = ()
    # kernel switch of the hot path: None = auto (CUDA kernels for CUDA
    # tensors, plain versions on the CPU); True/False force it
    use_pallas: bool | None = None
    wire_codec: object = None
    device: str = "cuda"

    @property
    def attn_cfg(self) -> layers.AttnConfig:
        a = self.arch
        return layers.AttnConfig(
            d_model=a.d_model, num_heads=a.num_heads,
            num_kv_heads=a.num_kv_heads, head_dim=a.head_dim_,
            rope_theta=a.rope_theta, sliding_window=a.sliding_window,
            qkv_bias=a.qkv_bias, dtype=a.torch_dtype,
            use_flash_kernel=self.use_flash)

    @property
    def moe_cfg(self) -> moe_base.MoEConfig:
        a = self.arch
        return moe_base.MoEConfig(
            d_model=a.d_model, d_ff=a.moe.d_ff_expert,
            num_experts=a.moe.num_experts, top_k=a.moe.top_k,
            capacity_factor=a.moe.capacity_factor,
            num_shared_experts=a.moe.num_shared_experts,
            activation=a.activation, dtype=a.torch_dtype,
            wire_codec=self.wire_codec)

    @property
    def frac_levels(self) -> int:
        if self.plan is not None:
            return self.plan.num_stages
        if self.ep is not None:
            return self.ep.num_stages
        return 1

    def dispatch_for_layer(self, layer_idx: int | None,
                           decode: bool = False) -> str:
        """The per-layer override when present, else the mode default
        (decode defaults to the weights-stationary gather path)."""
        default = "gather" if decode else self.dispatch
        if layer_idx is None:
            return default
        return dict(self.dispatch_override).get(layer_idx, default)


def layer_plan(arch: ArchConfig):
    """Returns (prefix: [SubLayer], group: [SubLayer], n_groups).

    As in the reference, an MoE arch puts an MoE FFN in every layer after
    ``first_dense``: ``moe_period`` is not read."""
    if arch.family in ("ssm", "hybrid") or arch.family == "audio":
        raise NotImplementedError(f"{arch.family} models are not ported yet")
    mixer = "attn"
    if arch.is_moe:
        prefix = [SubLayer(mixer, "mlp")] * arch.moe.first_dense
        return prefix, [SubLayer(mixer, "moe")], \
            arch.num_layers - arch.moe.first_dense
    return [], [SubLayer(mixer, "mlp")], arch.num_layers


def layer_list(arch: ArchConfig) -> list:
    """The flat per-layer SubLayer list: prefix, then the repeated group."""
    prefix, group, n_groups = layer_plan(arch)
    return list(prefix) + list(group) * n_groups


def _init_sublayer(sub: SubLayer, ctx: ModelCtx, generator, device):
    a = ctx.arch
    if sub.mixer != "attn" or sub.cross:
        raise NotImplementedError(f"mixer {sub.mixer!r} is not ported yet")
    p = {"norm1": layers.init_norm(a.norm, a.d_model, device),
         "mixer": layers.init_attn(ctx.attn_cfg, generator, device)}
    if sub.ffn == "mlp":
        p["norm2"] = layers.init_norm(a.norm, a.d_model, device)
        p["ffn"] = layers.init_mlp(a.d_model, a.d_ff, a.activation,
                                   a.torch_dtype, generator, device)
    elif sub.ffn == "moe":
        p["norm2"] = layers.init_norm(a.norm, a.d_model, device)
        p["ffn"] = moe_base.init_moe_params(ctx.moe_cfg, ctx.ep, ctx.gate_cfg,
                                            generator, device)
    return p


def init_model(ctx: ModelCtx, generator, device=None):
    """Fresh parameters: ``{"embed", "final_norm", "layers": [...]}``."""
    device = device or ctx.device
    a = ctx.arch
    params = {"embed": layers.init_embed(a.vocab_size, a.d_model,
                                         a.torch_dtype, generator, device),
              "final_norm": layers.init_norm(a.norm, a.d_model, device)}
    params["layers"] = [_init_sublayer(sub, ctx, generator, device)
                        for sub in layer_list(a)]
    return params


def _moe_block(p, x, ctx: ModelCtx, decode: bool, layer_idx=None):
    """x: [B, S, d] -> (y, metrics) through the layer's dispatch path."""
    d = x.shape[-1]
    name = ctx.dispatch_for_layer(layer_idx, decode)
    eng = dispatch_lib.make_engine(
        name, cfg=ctx.moe_cfg, ep=ctx.ep, gate_cfg=ctx.gate_cfg,
        plan=ctx.plan, tokens_replicated=ctx.decode_replicated and decode,
        use_pallas=ctx.use_pallas)
    y, metrics = eng(p, x.reshape(-1, d))
    return y.reshape(x.shape), metrics
