"""Decode-time forward: fused prefill and one-token decode steps against
per-layer caches (the counterpart of ``repro/models/decode.py``).

The cache is a list with one dict per layer (the reference stacks the
repeated group on a leading axis), whose ``"mixer"`` part is ``{"k",
"v", "pos"}`` for attention, the compressed ``{"c_kv", "k_rope", "pos"}``
for MLA, the recurrent ``{"h", "conv"}`` state for Mamba, ``{"C", "n",
"m"}`` for mLSTM and ``{"c", "n", "h", "m"}`` for sLSTM; a Whisper
decoder layer adds a ``"cross"`` part ``{"k", "v"}``, the encoder's K/V
of ``frontend_len`` rows, written at prefill and read by every step.
Under a model axis each part holds the rank's share: attention's and the
cross part's KV heads where attention is split, the rank's heads of an
mLSTM or sLSTM state and its channels of a Mamba state; MLA's latent
cache is whole on every rank.
The batch is axis 0 of every leaf; axis 1 is the position axis of the
leaves of a part with ``pos``, and only of those (the cross part has
none).  Decode steps and the slot operations update the cache tensors in
place and return the same cache, except that a recurrent step (Mamba,
mLSTM, sLSTM) puts a fresh state into its layer's dict.  A model with a
recurrent or cross-attention layer prefills by scanning decode steps over
the prompt, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import gather_rows
from repro_torch.models import layers
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.transformer import (ModelCtx, SubLayer, _moe_block,
                                            _run_encoder, full_logits,
                                            layer_list, splice_patches)
from repro_torch.sharding import copy_to_model, reduce_from_model


def init_cache(ctx: ModelCtx, batch: int, max_len: int, device=None):
    device = device or ctx.device
    cache = []
    for sub in layer_list(ctx.arch):
        if sub.mixer == "mla":
            c = mla_lib.init_mla_cache(batch, max_len, ctx.mla_cfg, device)
        elif sub.mixer == "mamba":
            c = mamba_lib.init_mamba_state(batch, ctx.mamba_cfg, device)
        elif sub.mixer == "mlstm":
            c = xlstm_lib.init_mlstm_state(batch, ctx.xlstm_cfg, device)
        elif sub.mixer == "slstm":
            c = xlstm_lib.init_slstm_state(batch, ctx.xlstm_cfg, device)
        else:
            c = layers.init_kv_cache(batch, max_len, ctx.attn_cfg, device)
        layer = {"mixer": c}
        if sub.cross:
            # the encoder's K/V, written at prefill; zeros here
            a = ctx.attn_cfg
            shape = (batch, ctx.arch.frontend_len or 1, a.num_kv_heads,
                     a.head_dim)
            layer["cross"] = {
                name: torch.zeros(shape, dtype=a.dtype, device=device)
                for name in ("k", "v")}
        cache.append(layer)
    return cache


def fill_cross_cache(params, cache, enc_out, ctx: ModelCtx):
    """The encoder output [B, F, d] projected into every cross-attention
    layer's K/V (new tensors in the cache's dicts; the rank's KV heads
    under a split attention); returns the cache."""
    a = ctx.attn_cfg
    B, Fn, _ = enc_out.shape
    for p, layer, sub in zip(params["layers"], cache, layer_list(ctx.arch)):
        if sub.cross:
            layer["cross"] = {
                name: (enc_out @ p["cross"][w]).reshape(
                    B, Fn, a.num_kv_heads, a.head_dim).to(a.dtype)
                for name, w in (("k", "wk"), ("v", "wv"))}
    return cache


# ---------------------------------------------------------------------------
# slot-indexed cache ops (continuous-batching serving)
# ---------------------------------------------------------------------------


def _slot_rows(slots, num_rows: int, device):
    """Slot ids as a device index, without the ids >= ``num_rows`` (the
    reference's out-of-bounds scatters drop them: padded admission rows
    carry slot id ``num_rows``).  Returns ``(rows, keep)`` where ``keep``
    selects the kept entries of the source batch."""
    ids = torch.as_tensor(slots).to("cpu", torch.int64)
    keep = ids < num_rows
    return ids[keep].to(device), keep.nonzero().flatten().to(device)


def _batch_leaf(cache):
    """Any leaf of ``cache``: every leaf has the batch on axis 0."""
    return next(iter(cache[0]["mixer"].values()))


def _positional(c) -> bool:
    """Whether the leaves of a part ``c`` of a layer's cache (of more than
    one dimension) have a position axis (axis 1): those of attention and
    MLA, which carry ``pos``; a recurrent state and the cross K/V have
    none."""
    return "pos" in c


def cache_insert_slots(dst, src, slots):
    """Write ``src`` (leading batch P) into ``dst`` (leading batch N) at
    ``slots`` [P], in place; slot ids >= N are dropped.  A source shorter
    than ``dst`` on the position axis fills the first positions of each
    slot and zeroes the rest."""
    leaf0 = _batch_leaf(dst)
    rows, keep = _slot_rows(slots, leaf0.shape[0], leaf0.device)
    for d_layer, s_layer in zip(dst, src):
        for part, c in d_layer.items():
            positional = _positional(c)
            for name, leaf in c.items():
                val = s_layer[part][name].index_select(0, keep).to(leaf.dtype)
                if positional and val.dim() > 1 and \
                        val.shape[1] < leaf.shape[1]:
                    leaf[rows] = 0
                    leaf[rows, :val.shape[1]] = val
                else:
                    leaf[rows] = val
    return dst


def gather_cache_rows(world, cache, length: int):
    """A pack cache's rows from every rank of ``world`` (world rank
    order), its positions ``[0, length)`` only: the source for
    :func:`cache_insert_slots` on each rank.  ``cache`` itself without a
    world of more than one rank."""
    if world is None or world.size == 1:
        return cache
    def cut(c, leaf):
        if _positional(c) and leaf.dim() > 1:
            return leaf[:, :length]
        return leaf

    return [{part: {name: gather_rows(world, cut(c, leaf))
                    for name, leaf in c.items()}
             for part, c in layer.items()}
            for layer in cache]


def cache_evict_slots(cache, slots):
    """Zero every cache leaf at ``slots`` in place (pos included, so the
    slot reads as empty)."""
    leaf0 = _batch_leaf(cache)
    rows, _ = _slot_rows(slots, leaf0.shape[0], leaf0.device)
    for layer in cache:
        for c in layer.values():
            for leaf in c.values():
                leaf[rows] = 0
    return cache


def _decode_sublayer(p, c, x, sub: SubLayer, ctx: ModelCtx, layer_idx=None):
    a = ctx.arch
    tp = ctx.tp
    h = layers.norm_apply(p["norm1"], x, a.norm)
    if sub.mixer == "mla":
        mix, c["mixer"] = mla_lib.mla_decode(p["mixer"], h, c["mixer"],
                                             ctx.mla_cfg, tp=tp)
    elif sub.mixer == "mamba":
        mix, c["mixer"] = mamba_lib.mamba_decode(p["mixer"], h, c["mixer"],
                                                 ctx.mamba_cfg, tp=tp)
    elif sub.mixer == "mlstm":
        mix, c["mixer"] = xlstm_lib.mlstm_decode(p["mixer"], h, c["mixer"],
                                                 ctx.xlstm_cfg, tp=tp)
    elif sub.mixer == "slstm":
        mix, c["mixer"] = xlstm_lib.slstm_decode(p["mixer"], h, c["mixer"],
                                                 ctx.xlstm_cfg, tp=tp)
    else:
        mix, c["mixer"] = layers.attn_decode(p["mixer"], h, c["mixer"],
                                             ctx.attn_cfg, tp=ctx.attn_tp)
    x = x + mix
    if sub.cross:
        h = layers.norm_apply(p["norm_cross"], x, a.norm)
        cfg = ctx.attn_cfg
        B = x.shape[0]
        q = (copy_to_model(h, ctx.attn_tp) @ p["cross"]["wq"]).reshape(
            B, 1, cfg.num_heads, cfg.head_dim)
        k, v = c["cross"]["k"], c["cross"]["v"]
        out = layers._sdpa(q, k, v, causal=False, sliding_window=0,
                           q_positions=torch.zeros((1,), dtype=torch.int64,
                                                   device=x.device),
                           k_positions=torch.arange(k.shape[1],
                                                    device=x.device))
        x = x + reduce_from_model(out.reshape(B, 1, -1) @ p["cross"]["wo"],
                                  ctx.attn_tp)
    if sub.ffn == "mlp":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        x = x + layers.mlp_apply(p["ffn"], h, a.activation, tp=ctx.mlp_tp)
    elif sub.ffn == "moe":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        y, _ = _moe_block(p["ffn"], h, ctx, decode=True, layer_idx=layer_idx)
        x = x + y
    return x, c


def decode_step(params, cache, tokens, ctx: ModelCtx):
    """tokens: [B, 1] -> (logits [B, 1, V] float32, cache updated in
    place)."""
    a = ctx.arch
    x = layers.embed_apply(params["embed"], tokens, ctx.vocab_tp)
    for i, sub in enumerate(layer_list(a)):
        x, cache[i] = _decode_sublayer(params["layers"][i], cache[i], x, sub,
                                       ctx, layer_idx=i)
    x = layers.norm_apply(params["final_norm"], x, a.norm)
    return full_logits(params, x, ctx), cache


# ---------------------------------------------------------------------------
# fused prefill: full-sequence forward that materializes the decode cache
# ---------------------------------------------------------------------------


def _prefill_sublayer(p, c, x, sub: SubLayer, ctx: ModelCtx, lens,
                      layer_idx=None):
    """Full-sequence sublayer forward that also writes the decode cache
    for positions [0, S) (K/V, or MLA's compressed entries) with ``pos``
    set to each request's true prompt length."""
    a = ctx.arch
    S = x.shape[1]
    h = layers.norm_apply(p["norm1"], x, a.norm)
    if sub.mixer == "mla":
        mix, entry = mla_lib.mla_apply(p["mixer"], h, ctx.mla_cfg, tp=ctx.tp)
    else:
        mix, (k, v) = layers.attn_apply(p["mixer"], h, ctx.attn_cfg,
                                        tp=ctx.attn_tp)
        entry = {"k": k, "v": v}
    cached = c["mixer"]
    for name, val in entry.items():
        cached[name][:, :S] = val.to(cached[name].dtype)
    cached["pos"] = lens.clone()
    x = x + mix
    if sub.ffn == "mlp":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        x = x + layers.mlp_apply(p["ffn"], h, a.activation, tp=ctx.mlp_tp)
    elif sub.ffn == "moe":
        # decode=True: the gather path computes every token independently
        # (no capacity drops), so a packed prefill equals prefilling each
        # request alone
        h = layers.norm_apply(p["norm2"], x, a.norm)
        y, _ = _moe_block(p["ffn"], h, ctx, decode=True, layer_idx=layer_idx)
        x = x + y
    return x, c


def _needs_scan_prefill(arch) -> bool:
    """Recurrent mixers (Mamba, xLSTM) and cross-attention decoders carry
    per-step state the full-sequence applies do not expose, so such models
    prefill by scanning :func:`decode_step` over the prompt, as the
    reference does."""
    return any(sub.mixer not in ("attn", "mla") or sub.cross
               for sub in layer_list(arch))


def _freeze_rows(cache, before, active):
    """Undo one decode step for the requests whose ``active`` [B] is
    False (their prompts ended): the counterpart of the reference's
    ``_select_batch``.  ``before`` holds each layer's mixer dict as it
    was before the step; the step replaced ``pos`` and every recurrent
    state (Mamba, mLSTM, sLSTM) with fresh tensors, so the old ones are intact there.  The K/V row a
    frozen request's step wrote in place at its ``pos`` stays: no query
    attends it before the request's next decode step overwrites it."""
    for layer, old in zip(cache, before):
        c = layer["mixer"]
        for name in (("pos",) if _positional(c) else tuple(c)):
            keep = active.view((-1,) + (1,) * (c[name].dim() - 1))
            c[name] = torch.where(keep, c[name], old[name])


def _prefill_by_scan(params, tokens, cache, ctx: ModelCtx, lens):
    """Prefill of recurrent models: one :func:`decode_step` a prompt
    position.  A request's cache freezes once ``t >= lens[b]`` (right
    padding cannot move its state), and its logits at ``t == lens - 1``
    are kept."""
    B, S = tokens.shape
    last = torch.zeros((B, ctx.arch.vocab_size), dtype=torch.float32,
                       device=tokens.device)
    for t in range(S):
        before = [dict(layer["mixer"]) for layer in cache]
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], ctx)
        _freeze_rows(cache, before, t < lens)
        last = torch.where((lens - 1 == t)[:, None], logits[:, 0], last)
    return last, cache


def prefill(params, batch, ctx: ModelCtx, *, cache_len: int, lens=None):
    """Fused prefill over right-padded prompts.

    batch: {"tokens": [B, S], optional "frontend"}; ``lens`` [B] gives each
    request's true prompt length (default S).  Returns ``(last_logits [B,
    V], cache)`` — the float32 logits at position ``lens - 1`` and a fresh
    cache of length ``cache_len`` with ``pos == lens``.  Attention and MLA
    models run the full-sequence forward and write their caches directly,
    a vision model's patches in place of its first ``frontend_len``
    positions; a model with a recurrent or cross-attention layer scans
    :func:`decode_step` over the prompt (``_needs_scan_prefill``), an
    audio model's encoder having filled the cross K/V first.
    """
    a = ctx.arch
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > cache_len:
        raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
    dev = tokens.device
    if lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lens, device=dev).to(torch.int32)
    cache = init_cache(ctx, B, cache_len, device=dev)
    if a.family == "audio" and "frontend" in batch:
        enc_out = _run_encoder(params, batch["frontend"].to(a.torch_dtype),
                               ctx)
        cache = fill_cross_cache(params, cache, enc_out, ctx)
    if _needs_scan_prefill(a):
        return _prefill_by_scan(params, tokens, cache, ctx, lens)

    x = layers.embed_apply(params["embed"], tokens, ctx.vocab_tp)
    if a.family == "vlm" and "frontend" in batch:
        x = splice_patches(params, x, batch["frontend"], ctx.tp)
    for i, sub in enumerate(layer_list(a)):
        x, cache[i] = _prefill_sublayer(params["layers"][i], cache[i], x, sub,
                                        ctx, lens, layer_idx=i)
    # the final norm and unembedding are row-wise: apply them to the one
    # row per request the caller needs
    last = torch.clamp(lens.long() - 1, min=0)
    x = x[torch.arange(B, device=dev), last][:, None]             # [B, 1, d]
    x = layers.norm_apply(params["final_norm"], x, a.norm)
    return full_logits(params, x, ctx)[:, 0], cache
