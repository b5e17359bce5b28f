"""Decoder assembly for the attention + MoE family (the counterpart of
``repro/models/transformer.py``: ``SubLayer``, ``ModelCtx``,
``layer_plan``, ``init_model``, ``_moe_block``, ``forward_features``,
``forward`` and ``loss_fn``).

The reference stacks the repeated layer group and runs it with
``lax.scan``; here parameters are a Python list of per-layer dicts
(``params["layers"]``) walked by a Python loop.  The reference runs each
MoE block under ``shard_map`` over the global batch; here every rank of
the EP world (``ctx.mesh``) runs the model on its own batch shard with
its own expert shard, and the block's metrics are averaged over the ranks
as the reference's ``pmean`` does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import gating
from repro_torch.core.dispatch import base as moe_base
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.models import layers
from repro_torch.models import mla as mla_lib


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str                    # attn | mla (mamba | mlstm | slstm: later)
    ffn: str | None               # mlp | moe | None
    cross: bool = False
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Everything the forward pass needs besides params and data."""
    arch: ArchConfig
    mesh: object | None = None        # launch.mesh.EPWorld; None = one rank
    ep: moe_base.EPSpec | None = None
    plan: object | None = None        # level-indexed a2a capacities
    gate_cfg: gating.GateConfig | None = None
    remat: bool = False               # recompute each layer in the backward
    use_flash: bool = False
    use_moe_kernel: bool = False      # MoEConfig.use_kernel: grouped_ffn
    decode_replicated: bool = False
    dispatch: str = "a2a"             # training-time default path
    a2a_num_chunks: int = 1           # pipelined chunks, set by build_ctx
    dispatch_override: tuple = ()
    # kernel switch of the hot path: None = auto (CUDA kernels for CUDA
    # tensors, plain versions on the CPU); True/False force it
    use_pallas: bool | None = None
    wire_codec: object = None
    fused_xent: bool = False          # loss through _fused_xent
    use_blockwise: bool = False       # attention by online softmax over
                                      # key blocks (layers._blockwise_sdpa)
    device: str = "cuda"

    @property
    def expert_range(self) -> tuple:
        """(first, end) global expert ids held by this rank."""
        n = self.arch.moe.num_experts
        if self.mesh is None or self.ep.ep_world == 1:
            return 0, n
        per = -(-n // self.ep.ep_world)
        r = self.mesh.rank % self.ep.ep_world
        return r * per, (r + 1) * per

    @property
    def attn_cfg(self) -> layers.AttnConfig:
        a = self.arch
        return layers.AttnConfig(
            d_model=a.d_model, num_heads=a.num_heads,
            num_kv_heads=a.num_kv_heads, head_dim=a.head_dim_,
            rope_theta=a.rope_theta, sliding_window=a.sliding_window,
            qkv_bias=a.qkv_bias, dtype=a.torch_dtype,
            use_flash_kernel=self.use_flash,
            use_blockwise=self.use_blockwise)

    @property
    def mla_cfg(self) -> mla_lib.MLAConfig:
        """MLA's config; it takes no ``use_flash``: MLA attends through
        plain PyTorch (or blockwise), as the reference's does."""
        a = self.arch
        m = a.mla
        return mla_lib.MLAConfig(
            d_model=a.d_model, num_heads=a.num_heads,
            kv_lora_rank=m.kv_lora_rank, qk_nope_dim=m.qk_nope_dim,
            qk_rope_dim=m.qk_rope_dim, v_dim=m.v_dim,
            q_lora_rank=m.q_lora_rank, rope_theta=a.rope_theta,
            dtype=a.torch_dtype, use_blockwise=self.use_blockwise)

    @property
    def moe_cfg(self) -> moe_base.MoEConfig:
        a = self.arch
        return moe_base.MoEConfig(
            d_model=a.d_model, d_ff=a.moe.d_ff_expert,
            num_experts=a.moe.num_experts, top_k=a.moe.top_k,
            capacity_factor=a.moe.capacity_factor,
            num_shared_experts=a.moe.num_shared_experts,
            activation=a.activation, dtype=a.torch_dtype,
            use_kernel=self.use_moe_kernel, wire_codec=self.wire_codec)

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
    mixer = "mla" if arch.mla else "attn"
    if arch.is_moe:
        prefix = [SubLayer(mixer, "mlp")] * arch.moe.first_dense
        return prefix, [SubLayer(mixer, "moe")], \
            arch.num_layers - arch.moe.first_dense
    return [], [SubLayer(mixer, "mlp")], arch.num_layers


def layer_list(arch: ArchConfig) -> list:
    """The flat per-layer SubLayer list: prefix, then the repeated group."""
    prefix, group, n_groups = layer_plan(arch)
    return list(prefix) + list(group) * n_groups


def _check_mixer(sub: SubLayer) -> None:
    if sub.mixer not in ("attn", "mla") or sub.cross:
        raise NotImplementedError(f"mixer {sub.mixer!r} (cross={sub.cross}) "
                                  f"is not ported yet")


def _init_sublayer(sub: SubLayer, ctx: ModelCtx, generator, device):
    a = ctx.arch
    _check_mixer(sub)
    p = {"norm1": layers.init_norm(a.norm, a.d_model, device)}
    if sub.mixer == "mla":
        p["mixer"] = mla_lib.init_mla(ctx.mla_cfg, generator, device)
    else:
        p["mixer"] = layers.init_attn(ctx.attn_cfg, generator, device)
    if sub.ffn == "mlp":
        p["norm2"] = layers.init_norm(a.norm, a.d_model, device)
        p["ffn"] = layers.init_mlp(a.d_model, a.d_ff, a.activation,
                                   a.torch_dtype, generator, device)
    elif sub.ffn == "moe":
        p["norm2"] = layers.init_norm(a.norm, a.d_model, device)
        p["ffn"] = moe_base.init_moe_params(ctx.moe_cfg, ctx.ep, ctx.gate_cfg,
                                            generator, device)
        lo, hi = ctx.expert_range
        for name in moe_base.EXPERT_PARAMS:
            if name in p["ffn"]:
                p["ffn"][name] = p["ffn"][name][lo:hi].clone()
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
    """x: [B, S, d] (this rank's shard) -> (y, metrics) through the
    layer's dispatch path; the metrics are world means (the aux loss keeps
    this rank's gradient, see :func:`_world_mean`)."""
    d = x.shape[-1]
    name = ctx.dispatch_for_layer(layer_idx, decode)
    eng = dispatch_lib.make_engine(
        name, cfg=ctx.moe_cfg, ep=ctx.ep, gate_cfg=ctx.gate_cfg,
        plan=ctx.plan, num_chunks=max(1, ctx.a2a_num_chunks),
        tokens_replicated=ctx.decode_replicated and decode,
        use_pallas=ctx.use_pallas, world=ctx.mesh)
    y, metrics = eng(p, x.reshape(-1, d))
    if ctx.mesh is not None and ctx.mesh.size > 1:
        metrics = _world_mean(metrics, ctx.mesh)
    return y.reshape(x.shape), metrics


def _world_mean(metrics, world):
    """The reference's ``pmean`` of the uniform metrics over the ranks, in
    one all-reduce.  The aux loss takes the world mean's value and keeps
    this rank's own gradient: each rank backpropagates its local loss over
    the world size, which gives ``pmean``'s gradient."""
    out = world.mean(metrics)
    aux = metrics["aux_loss"]
    out["aux_loss"] = aux + (out["aux_loss"] - aux).detach()
    return out


# ---------------------------------------------------------------------------
# forward (training / full-sequence)
# ---------------------------------------------------------------------------


def _apply_sublayer(p, x, sub: SubLayer, ctx: ModelCtx, aux, frac, drop,
                    layer_idx=None):
    """Returns (x, aux, frac, drop): the residual stream and the
    accumulated aux loss, per-level dispatch fractions and dropped share
    (``frac`` / ``drop`` pass through unchanged for non-MoE sublayers)."""
    _check_mixer(sub)
    a = ctx.arch
    h = layers.norm_apply(p["norm1"], x, a.norm)
    if sub.mixer == "mla":
        mix, _ = mla_lib.mla_apply(p["mixer"], h, ctx.mla_cfg)
    else:
        cfg = ctx.attn_cfg
        if not sub.causal:
            cfg = dataclasses.replace(cfg, causal=False)
        mix, _ = layers.attn_apply(p["mixer"], h, cfg)
    x = x + mix
    if sub.ffn == "mlp":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        x = x + layers.mlp_apply(p["ffn"], h, a.activation)
    elif sub.ffn == "moe":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        y, metrics = _moe_block(p["ffn"], h, ctx, decode=False,
                                layer_idx=layer_idx)
        x = x + y
        aux = aux + metrics["aux_loss"]
        frac = frac + metrics["frac_by_level"]
        drop = drop + metrics["dropped"]
    return x, aux, frac, drop


def forward_features(params, batch, ctx: ModelCtx):
    """Full-sequence forward up to the final norm.  Returns ``(x, aux,
    frac_by_level, dropped)``: features, the mean aux loss per group
    layer, and the mean per-level dispatch fractions and dropped share over
    the MoE layers (None without MoE layers).

    With ``ctx.remat`` each layer runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint`` of each scanned group): its
    activations are not kept, and the backward runs its forward again,
    kernels and collectives included.  Every rank recomputes in the same
    order, so the all-to-all chains still pair up."""
    a = ctx.arch
    if "frontend" in batch:
        raise NotImplementedError("modality frontends are not ported yet")
    prefix, group, n_groups = layer_plan(a)
    x = layers.embed_apply(params["embed"], batch["tokens"])
    dev = x.device
    n_moe = n_groups * sum(1 for s in group if s.ffn == "moe")
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    frac = torch.zeros((ctx.frac_levels,), dtype=torch.float32, device=dev)
    drop = torch.zeros((), dtype=torch.float32, device=dev)
    remat = ctx.remat and torch.is_grad_enabled()
    for i, sub in enumerate(layer_list(a)):
        if remat:
            x, aux, frac, drop = checkpoint(
                _apply_sublayer, params["layers"][i], x, sub, ctx, aux,
                frac, drop, layer_idx=i, use_reentrant=False)
        else:
            x, aux, frac, drop = _apply_sublayer(params["layers"][i], x,
                                                 sub, ctx, aux, frac, drop,
                                                 layer_idx=i)
    x = layers.norm_apply(params["final_norm"], x, a.norm)
    aux = aux / max(1, n_groups * len(group))
    if not n_moe:
        return x, aux, None, None
    return x, aux, frac / n_moe, drop / n_moe


def forward(params, batch, ctx: ModelCtx):
    """Full-sequence forward.  Returns (float32 logits, aux)."""
    x, aux, _, _ = forward_features(params, batch, ctx)
    return layers.unembed_apply(params["embed"], x), aux


def _fused_xent(params, x, labels):
    """Per-token NLL [B, S] from logits in the model dtype (``x @
    table.T``, one bf16 GEMM where the default path casts both operands
    to float32): the max (no gradient), the log-sum-exp and the label's
    logit by an ``arange == label`` mask, as the reference's vocab-sharded
    ``_fused_xent`` computes them (plain PyTorch: the reference's is no
    Pallas kernel)."""
    table = params["embed"]["table"]                         # [V, d]
    logits = x @ table.T.to(x.dtype)                          # [B, S, V]
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    onehot = (torch.arange(lf.shape[-1], device=lf.device)
              == labels.long()[..., None])
    label_logit = torch.sum(torch.where(onehot, lf, 0.0), dim=-1)
    return lse - label_logit


def loss_fn(params, batch, ctx: ModelCtx, aux_weight: float = 1.0):
    """Masked mean next-token NLL over this rank's batch + ``aux_weight``
    times the aux loss (the NLL through :func:`_fused_xent` when
    ``ctx.fused_xent``).  Returns ``(total, metrics)``."""
    labels = batch["labels"]
    x, aux, frac, drop = forward_features(params, batch, ctx)
    if ctx.fused_xent:
        nll = _fused_xent(params, x, labels)
    else:
        logits = layers.unembed_apply(params["embed"], x)
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    nll = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = nll + aux_weight * aux
    metrics = {"nll": nll, "aux": aux, "loss": total}
    if frac is not None:
        metrics["frac_by_level"] = frac
    if drop is not None:
        metrics["dropped"] = drop
    return total, metrics
