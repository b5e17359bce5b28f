"""Decoder and encoder-decoder assembly over every mixer family (the
counterpart of ``repro/models/transformer.py``: ``SubLayer``,
``ModelCtx``, ``layer_plan``, ``encoder_plan``, ``init_model``,
``_moe_block``, ``_cross_attn``, ``_run_encoder``, ``forward_features``,
``forward`` and ``loss_fn``).

    mixer: attn (GQA, optional sliding window; causal or not) | mla |
           mamba | mlstm | slstm; plus cross-attention (Whisper's decoder)
    ffn  : mlp | moe | None

The reference stacks the repeated layer group and runs it with
``lax.scan``; here parameters are a Python list of per-layer dicts
(``params["layers"]``) walked by a Python loop.  The reference runs each
MoE block under ``shard_map`` over the global batch; here every rank of
the EP world (``ctx.mesh``) runs the model on its own batch shard with
its own expert shard, and the block's metrics are averaged over the ranks
as the reference's ``pmean`` does.

A world with a ``model`` axis (tensor parallelism, the reference's
``model`` mesh axis under GSPMD) runs every layer on the same tokens on
each of its model ranks, each with its slice of the weights
(``models.model.shard_params``): attention by heads when the axis divides
the query and the KV heads (``ModelCtx.attn_sharded``; replicated
otherwise), Whisper's cross-attention and encoder alike, the dense FFN by
its width, the experts and shared experts by theirs
(``core.dispatch.base``), MLA and the xLSTM mixers by heads, Mamba by
its inner channels, InternVL2's projector by its width, the embedding
table by vocabulary rows, whose logits and loss are then vocab-parallel.
Every layer's output and the encoder's are whole on every model rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.sharding import copy_to_model, reduce_from_model
from repro_torch.configs.base import ArchConfig
from repro_torch.core import gating
from repro_torch.core.dispatch import base as moe_base
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.models import layers
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import vlm
from repro_torch.models import xlstm as xlstm_lib

@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str                    # attn | mla | mamba | mlstm | slstm
    ffn: str | None               # mlp | moe | None
    cross: bool = False           # add cross-attention (whisper decoder)
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
    a2a_dtype: str = ""               # deprecated: use wire_codec
    wire_codec: object = None
    fused_xent: bool = False          # loss through _fused_xent
    use_blockwise: bool = False       # attention by online softmax over
                                      # key blocks (layers._blockwise_sdpa)
    mamba_scan_chunk: int = 0         # chunked selective scan
    xlstm_chunk: int = 0              # chunkwise mLSTM
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
    def tp(self):
        """The world when it has a model axis above 1, else None."""
        return sharding.tp_world(self.mesh)

    def _tp_if(self, width: int):
        tp = self.tp
        return tp if tp is not None and width % tp.model == 0 else None

    @property
    def attn_sharded(self) -> bool:
        """Whether attention is split by heads over the model axis: it
        divides the query and the KV heads."""
        tp = self.tp
        return (tp is not None and self.arch.num_heads % tp.model == 0
                and self.arch.num_kv_heads % tp.model == 0)

    @property
    def attn_tp(self):
        return self.tp if self.attn_sharded else None

    @property
    def mlp_tp(self):
        return self._tp_if(self.arch.d_ff)

    @property
    def vocab_tp(self):
        return self._tp_if(self.arch.vocab_size)

    @property
    def attn_cfg(self) -> layers.AttnConfig:
        """The rank's attention config: its heads under a sharded
        attention, every head otherwise."""
        cfg = self.full_attn_cfg
        if self.attn_sharded:
            m = self.tp.model
            cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                                      num_kv_heads=cfg.num_kv_heads // m)
        return cfg

    @property
    def full_attn_cfg(self) -> layers.AttnConfig:
        a = self.arch
        return layers.AttnConfig(
            d_model=a.d_model, num_heads=a.num_heads,
            num_kv_heads=a.num_kv_heads, head_dim=a.head_dim_,
            rope_theta=a.rope_theta, sliding_window=a.sliding_window,
            qkv_bias=a.qkv_bias, dtype=a.torch_dtype,
            use_flash_kernel=self.use_flash,
            use_blockwise=self.use_blockwise)

    @property
    def shards(self) -> int:
        """The model ranks a layer is split over (1 without an axis)."""
        tp = self.tp
        return 1 if tp is None else tp.model

    @property
    def mla_cfg(self) -> mla_lib.MLAConfig:
        """The rank's MLA config: its heads under a model axis."""
        cfg = self.full_mla_cfg
        if self.shards > 1:
            cfg = dataclasses.replace(
                cfg, num_heads=cfg.num_heads // self.shards)
        return cfg

    @property
    def full_mla_cfg(self) -> mla_lib.MLAConfig:
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
    def mamba_cfg(self) -> mamba_lib.MambaConfig:
        return mamba_lib.MambaConfig(d_model=self.arch.d_model,
                                     dtype=self.arch.torch_dtype,
                                     scan_chunk=self.mamba_scan_chunk,
                                     shards=self.shards)

    @property
    def xlstm_cfg(self) -> xlstm_lib.XLSTMConfig:
        a = self.arch
        return xlstm_lib.XLSTMConfig(d_model=a.d_model, num_heads=a.num_heads,
                                     slstm_every=a.slstm_every or 8,
                                     dtype=a.torch_dtype,
                                     chunk_size=self.xlstm_chunk,
                                     shards=self.shards)

    @property
    def moe_cfg(self) -> moe_base.MoEConfig:
        a = self.arch
        return moe_base.MoEConfig(
            d_model=a.d_model, d_ff=a.moe.d_ff_expert,
            num_experts=a.moe.num_experts, top_k=a.moe.top_k,
            capacity_factor=a.moe.capacity_factor,
            num_shared_experts=a.moe.num_shared_experts,
            activation=a.activation, dtype=a.torch_dtype,
            use_kernel=self.use_moe_kernel, a2a_dtype=self.a2a_dtype,
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

    xLSTM repeats a group of ``slstm_every`` blocks, mLSTM then one sLSTM
    last, none with an FFN.  A hybrid (Jamba) repeats a group of
    ``attn_every`` layers: attention at ``attn_offset``, Mamba elsewhere, an MoE FFN where ``j %
    moe_period == moe_period - 1`` and a dense one at the others.  As in
    the reference, any other MoE arch puts an MoE FFN in every layer after
    ``first_dense``: there ``moe_period`` is not read.  Whisper's decoder
    layers add cross-attention."""
    if arch.family == "ssm" and arch.ssm_kind == "xlstm":
        g = arch.slstm_every or 8
        group = [SubLayer("slstm" if j == g - 1 else "mlstm", None)
                 for j in range(g)]
        return [], group, arch.num_layers // g
    if arch.family == "hybrid":
        g = arch.attn_every
        group = []
        for j in range(g):
            mixer = "attn" if j == arch.attn_offset else "mamba"
            ffn = "moe" if (arch.moe and j % arch.moe.moe_period
                            == arch.moe.moe_period - 1) else "mlp"
            group.append(SubLayer(mixer, ffn))
        return [], group, arch.num_layers // g
    mixer = "mla" if arch.mla else "attn"
    if arch.is_moe:
        prefix = [SubLayer(mixer, "mlp")] * arch.moe.first_dense
        return prefix, [SubLayer(mixer, "moe")], \
            arch.num_layers - arch.moe.first_dense
    # dense / vlm / audio decoder
    return [], [SubLayer(mixer, "mlp", cross=arch.family == "audio")], \
        arch.num_layers


def encoder_plan(arch: ArchConfig):
    """Whisper's encoder: ``(group, n_layers)``, one non-causal attention
    layer with a dense FFN, repeated ``enc_layers`` times."""
    return [SubLayer("attn", "mlp", causal=False)], arch.enc_layers


def mamba_inner(arch: ArchConfig) -> int:
    """Mamba's inner width ``d_inner`` for ``arch``."""
    return mamba_lib.MambaConfig(d_model=arch.d_model).d_inner


def layer_list(arch: ArchConfig) -> list:
    """The flat per-layer SubLayer list: prefix, then the repeated group."""
    prefix, group, n_groups = layer_plan(arch)
    return list(prefix) + list(group) * n_groups


def _init_sublayer(sub: SubLayer, ctx: ModelCtx, generator, device):
    a = ctx.arch
    p = {"norm1": layers.init_norm(a.norm, a.d_model, device)}
    if sub.mixer == "mla":
        p["mixer"] = mla_lib.init_mla(ctx.full_mla_cfg, generator, device)
    elif sub.mixer == "mamba":
        p["mixer"] = mamba_lib.init_mamba(ctx.mamba_cfg, generator, device)
    elif sub.mixer == "mlstm":
        p["mixer"] = xlstm_lib.init_mlstm(ctx.xlstm_cfg, generator, device)
    elif sub.mixer == "slstm":
        p["mixer"] = xlstm_lib.init_slstm(ctx.xlstm_cfg, generator, device)
    else:
        p["mixer"] = layers.init_attn(ctx.full_attn_cfg, generator, device)
    if sub.cross:
        p["norm_cross"] = layers.init_norm(a.norm, a.d_model, device)
        p["cross"] = layers.init_attn(ctx.full_attn_cfg, generator, device)
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


def init_model(ctx: ModelCtx, generator, device=None, keep=None):
    """Fresh parameters: ``{"embed", "final_norm", "layers": [...]}``, and
    a vision model's 2-layer projector ``"proj"`` (ViT width 1024 ->
    d_model), an encoder-decoder's ``"enc_layers": [...]`` and
    ``"enc_norm"``.  ``keep(path, subtree)`` (``models.model.
    init_params``' slicing) is applied to each layer as soon as it is
    drawn, so the whole model is never held at once; the draws are the
    same."""
    device = device or ctx.device
    a = ctx.arch
    keep = keep or (lambda path, tree: tree)
    params = {"embed": layers.init_embed(a.vocab_size, a.d_model,
                                         a.torch_dtype, generator, device),
              "final_norm": layers.init_norm(a.norm, a.d_model, device)}
    params["layers"] = [keep(("layers", str(i)),
                             _init_sublayer(sub, ctx, generator, device))
                        for i, sub in enumerate(layer_list(a))]
    if a.frontend == "vision":
        w = vlm.VIT_WIDTH
        params["proj"] = {
            "w1": layers._normal((w, a.d_model), 1 / np.sqrt(w), generator,
                                 device).to(a.torch_dtype),
            "w2": layers._normal((a.d_model, a.d_model), 1 / np.sqrt(
                a.d_model), generator, device).to(a.torch_dtype)}
    if a.enc_layers:
        (esub,), n_enc = encoder_plan(a)
        params["enc_layers"] = [keep(("enc_layers", str(i)),
                                     _init_sublayer(esub, ctx, generator,
                                                    device))
                                for i in range(n_enc)]
        params["enc_norm"] = layers.init_norm(a.norm, a.d_model, device)
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
                    layer_idx=None, enc_out=None):
    """Returns (x, aux, frac, drop): the residual stream and the
    accumulated aux loss, per-level dispatch fractions and dropped share
    (``frac`` / ``drop`` pass through unchanged for non-MoE sublayers).
    A cross-attention sublayer attends ``enc_out`` when given."""
    a = ctx.arch
    h = layers.norm_apply(p["norm1"], x, a.norm)
    tp = ctx.tp
    if sub.mixer == "mla":
        mix, _ = mla_lib.mla_apply(p["mixer"], h, ctx.mla_cfg, tp=tp)
    elif sub.mixer == "mamba":
        mix = mamba_lib.mamba_apply(p["mixer"], h, ctx.mamba_cfg, tp=tp)
    elif sub.mixer == "mlstm":
        mix = xlstm_lib.mlstm_apply(p["mixer"], h, ctx.xlstm_cfg, tp=tp)
    elif sub.mixer == "slstm":
        mix, _ = xlstm_lib.slstm_apply(p["mixer"], h, ctx.xlstm_cfg,
                                       tp=tp)
    else:
        cfg = ctx.attn_cfg
        if not sub.causal:
            cfg = dataclasses.replace(cfg, causal=False)
        mix, _ = layers.attn_apply(p["mixer"], h, cfg, tp=ctx.attn_tp)
    x = x + mix
    if sub.cross and enc_out is not None:
        h = layers.norm_apply(p["norm_cross"], x, a.norm)
        x = x + _cross_attn(p["cross"], h, enc_out, ctx)
    if sub.ffn == "mlp":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        x = x + layers.mlp_apply(p["ffn"], h, a.activation, tp=ctx.mlp_tp)
    elif sub.ffn == "moe":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        y, metrics = _moe_block(p["ffn"], h, ctx, decode=False,
                                layer_idx=layer_idx)
        x = x + y
        aux = aux + metrics["aux_loss"]
        frac = frac + metrics["frac_by_level"]
        drop = drop + metrics["dropped"]
    return x, aux, frac, drop


def _cross_attn(p, x, enc_out, ctx: ModelCtx):
    """Full cross-attention of the decoder stream ``x`` [B, S, d] over the
    encoder output [B, F, d] (Whisper's decoder): no RoPE, no mask,
    through the plain ``_sdpa`` as in the reference.  Split by heads as
    self-attention is (``ModelCtx.attn_tp``): both inputs pass
    ``copy_to_model``, ``wo``'s rows end in one ``reduce_from_model``."""
    cfg = ctx.attn_cfg
    tp = ctx.attn_tp
    B, S, _ = x.shape
    Fn = enc_out.shape[1]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x, enc_out = copy_to_model(x, tp), copy_to_model(enc_out, tp)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (enc_out @ p["wk"]).reshape(B, Fn, K, hd)
    v = (enc_out @ p["wv"]).reshape(B, Fn, K, hd)
    dev = x.device
    out = layers._sdpa(q, k, v, causal=False, sliding_window=0,
                       q_positions=torch.arange(S, device=dev),
                       k_positions=torch.arange(Fn, device=dev))
    return reduce_from_model(out.reshape(B, S, -1) @ p["wo"], tp)


def _run_encoder(params, frames, ctx: ModelCtx):
    """Whisper's encoder over frame embeddings [B, F, d] (model dtype):
    ``enc_layers`` non-causal attention layers (K5 under ``use_flash``),
    then ``enc_norm``."""
    (esub,), _ = encoder_plan(ctx.arch)
    x = frames
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["enc_layers"]:
        x, _, _, _ = _apply_sublayer(p, x, esub, ctx, zero, zero, zero)
    return layers.norm_apply(params["enc_norm"], x, ctx.arch.norm)


def splice_patches(params, x, patches, tp=None):
    """A vision model's input: the projected patches [B, n, 1024] (through
    ``params["proj"]``: gelu between its two layers) in place of the
    first n token embeddings of ``x`` [B, S, d].  Under ``tp`` the
    projector is split by its width (``w1``'s columns, ``w2``'s rows,
    then one ``reduce_from_model``)."""
    n = patches.shape[1]
    if x.shape[1] < n:
        raise ValueError(f"{x.shape[1]} positions cannot hold the "
                         f"{n} patch embeddings of the frontend")
    proj = params["proj"]
    emb = F.gelu(copy_to_model(patches.to(x.dtype), tp) @ proj["w1"],
                 approximate="tanh") @ proj["w2"]
    emb = reduce_from_model(emb, tp)
    return torch.cat([emb, x[:, n:]], dim=1)


def frontend_inputs(params, batch, x, ctx: ModelCtx):
    """``(x, enc_out)``: the token embeddings ``x`` with a vision model's
    patches spliced in, and an audio model's encoder output (None for
    other families).  The audio family needs ``batch["frontend"]``."""
    a = ctx.arch
    if a.family == "audio":
        if "frontend" not in batch:
            raise ValueError("an audio model's forward needs "
                             "batch['frontend'] (frame embeddings)")
        return x, _run_encoder(params, batch["frontend"].to(x.dtype), ctx)
    if a.family == "vlm" and "frontend" in batch:
        return splice_patches(params, x, batch["frontend"], ctx.tp), None
    return x, None


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
    prefix, group, n_groups = layer_plan(a)
    x = layers.embed_apply(params["embed"], batch["tokens"], ctx.vocab_tp)
    x, enc_out = frontend_inputs(params, batch, x, ctx)
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
                frac, drop, layer_idx=i, enc_out=enc_out,
                use_reentrant=False)
        else:
            x, aux, frac, drop = _apply_sublayer(params["layers"][i], x,
                                                 sub, ctx, aux, frac, drop,
                                                 layer_idx=i, enc_out=enc_out)
    x = layers.norm_apply(params["final_norm"], x, a.norm)
    aux = aux / max(1, n_groups * len(group))
    if not n_moe:
        return x, aux, None, None
    return x, aux, frac / n_moe, drop / n_moe


def full_logits(params, x, ctx: ModelCtx):
    """Float32 logits over the whole vocabulary; under a vocab-sharded
    model axis the ranks' shards all-gathered in vocabulary order (no
    gradient: what serving samples, where an argmax picks the lowest id
    of a tie as over one row)."""
    tp = ctx.vocab_tp
    return sharding.gather_from_model(
        layers.unembed_apply(params["embed"], x, tp), tp)


def forward(params, batch, ctx: ModelCtx):
    """Full-sequence forward.  Returns (float32 logits, aux)."""
    x, aux, _, _ = forward_features(params, batch, ctx)
    return full_logits(params, x, ctx), aux


def _xent(lf, labels, start: int, tp):
    """Per-token NLL from float32 logits ``lf`` [B, S, V_rank] whose ids
    begin at ``start``: the max (no gradient), the log-sum-exp and the
    label's logit by an ``arange == label`` mask.  Under ``tp`` the max
    is the largest of the ranks' (gathered), and the sum of exponentials
    and the label's logit are summed over the model axis."""
    m = lf.amax(dim=-1, keepdim=True).detach()
    if tp is not None:
        m = tp.all_gather(m.reshape(1, -1), "model").amax(0).reshape(
            m.shape)
    sumexp = sharding.reduce_from_model(
        torch.sum(torch.exp(lf - m), dim=-1), tp)
    lse = torch.log(sumexp) + m[..., 0]
    onehot = (torch.arange(start, start + lf.shape[-1], device=lf.device)
              == labels.long()[..., None])
    label_logit = sharding.reduce_from_model(
        torch.sum(torch.where(onehot, lf, 0.0), dim=-1), tp)
    return lse - label_logit


def _fused_xent(params, x, labels, tp=None):
    """Per-token NLL [B, S] from logits in the model dtype (``x @
    table.T``, one bf16 GEMM where the default path casts both operands
    to float32) through :func:`_xent`, as the reference's vocab-sharded
    ``_fused_xent`` computes it (plain PyTorch: the reference's is no
    Pallas kernel).  ``tp``: the table holds the rank's vocabulary
    rows."""
    table = params["embed"]["table"]                         # [V, d]
    x = sharding.copy_to_model(x, tp)
    logits = x @ table.T.to(x.dtype)                          # [B, S, V]
    return _xent(logits.to(torch.float32), labels,
                 layers.vocab_start(params["embed"], tp), tp)


def loss_fn(params, batch, ctx: ModelCtx, aux_weight: float = 1.0):
    """Masked mean next-token NLL over this rank's batch (on a world, its
    masked sum over the world's mean mask count) + ``aux_weight``
    times the aux loss (the NLL through :func:`_fused_xent` when
    ``ctx.fused_xent``).  Returns ``(total, metrics)``."""
    labels = batch["labels"]
    x, aux, frac, drop = forward_features(params, batch, ctx)
    tp = ctx.vocab_tp
    if ctx.fused_xent:
        nll = _fused_xent(params, x, labels, tp)
    elif tp is not None:
        nll = _xent(layers.unembed_apply(params["embed"], x, tp), labels,
                    layers.vocab_start(params["embed"], tp), tp)
    else:
        logits = layers.unembed_apply(params["embed"], x)
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    count = torch.clamp(mask.sum(), min=1.0)
    world = ctx.mesh
    if world is not None and world.size > 1 and "loss_mask" in batch:
        # the reference's masked mean runs over the global batch: each rank
        # divides its sum by the world's mean count, so the world mean of
        # the ranks' losses is it (the same count on every rank gives the
        # rank's own mean, bit for bit)
        count = torch.clamp(world.all_reduce_sum(
            mask.sum().detach().reshape(1))[0], min=1.0) / world.size
    nll = (nll * mask).sum() / count
    total = nll + aux_weight * aux
    metrics = {"nll": nll, "aux": aux, "loss": total}
    if frac is not None:
        metrics["frac_by_level"] = frac
    if drop is not None:
        metrics["dropped"] = drop
    return total, metrics
