"""Decode-time forward: fused prefill and one-token decode steps against
per-layer caches (the counterpart of ``repro/models/decode.py`` for the
attention and MLA mixers).

The cache is a list with one ``{"mixer": {...}}`` dict per layer (the
reference stacks the repeated group on a leading axis): ``{"k", "v",
"pos"}`` for attention, the compressed ``{"c_kv", "k_rope", "pos"}`` for
MLA; the batch is axis 0 of every leaf.  Decode steps and the slot
operations update the cache tensors in place and return the same cache.
Other mixer families (mamba, xlstm, cross-attention) are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import gather_rows
from repro_torch.models import layers
from repro_torch.models import mla as mla_lib
from repro_torch.models.transformer import (ModelCtx, SubLayer, _check_mixer,
                                            _moe_block, layer_list)


def init_cache(ctx: ModelCtx, batch: int, max_len: int, device=None):
    device = device or ctx.device
    cache = []
    for sub in layer_list(ctx.arch):
        _check_mixer(sub)
        if sub.mixer == "mla":
            c = mla_lib.init_mla_cache(batch, max_len, ctx.mla_cfg, device)
        else:
            c = layers.init_kv_cache(batch, max_len, ctx.attn_cfg, device)
        cache.append({"mixer": c})
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


def cache_insert_slots(dst, src, slots):
    """Write ``src`` (leading batch P) into ``dst`` (leading batch N) at
    ``slots`` [P], in place; slot ids >= N are dropped.  A source shorter
    than ``dst`` on the position axis fills the first positions of each
    slot and zeroes the rest."""
    n = dst[0]["mixer"]["pos"].shape[0]
    dev = dst[0]["mixer"]["pos"].device
    rows, keep = _slot_rows(slots, n, dev)
    for d_layer, s_layer in zip(dst, src):
        for name, leaf in d_layer["mixer"].items():
            val = s_layer["mixer"][name].index_select(0, keep).to(leaf.dtype)
            if val.dim() > 1 and val.shape[1] < leaf.shape[1]:
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
    return [{"mixer": {name: gather_rows(world, leaf if leaf.dim() == 1
                                         else leaf[:, :length])
                       for name, leaf in layer["mixer"].items()}}
            for layer in cache]


def cache_evict_slots(cache, slots):
    """Zero every cache leaf at ``slots`` in place (pos included, so the
    slot reads as empty)."""
    n = cache[0]["mixer"]["pos"].shape[0]
    rows, _ = _slot_rows(slots, n, cache[0]["mixer"]["pos"].device)
    for layer in cache:
        for leaf in layer["mixer"].values():
            leaf[rows] = 0
    return cache


def _decode_sublayer(p, c, x, sub: SubLayer, ctx: ModelCtx, layer_idx=None):
    _check_mixer(sub)
    a = ctx.arch
    h = layers.norm_apply(p["norm1"], x, a.norm)
    if sub.mixer == "mla":
        mix, c["mixer"] = mla_lib.mla_decode(p["mixer"], h, c["mixer"],
                                             ctx.mla_cfg)
    else:
        mix, c["mixer"] = layers.attn_decode(p["mixer"], h, c["mixer"],
                                             ctx.attn_cfg)
    x = x + mix
    if sub.ffn == "mlp":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        x = x + layers.mlp_apply(p["ffn"], h, a.activation)
    elif sub.ffn == "moe":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        y, _ = _moe_block(p["ffn"], h, ctx, decode=True, layer_idx=layer_idx)
        x = x + y
    return x, c


def decode_step(params, cache, tokens, ctx: ModelCtx):
    """tokens: [B, 1] -> (logits [B, 1, V] float32, cache updated in
    place)."""
    a = ctx.arch
    x = layers.embed_apply(params["embed"], tokens)
    for i, sub in enumerate(layer_list(a)):
        x, cache[i] = _decode_sublayer(params["layers"][i], cache[i], x, sub,
                                       ctx, layer_idx=i)
    x = layers.norm_apply(params["final_norm"], x, a.norm)
    return layers.unembed_apply(params["embed"], x), cache


# ---------------------------------------------------------------------------
# fused prefill: full-sequence forward that materializes the decode cache
# ---------------------------------------------------------------------------


def _prefill_sublayer(p, c, x, sub: SubLayer, ctx: ModelCtx, lens,
                      layer_idx=None):
    """Full-sequence sublayer forward that also writes the decode cache
    for positions [0, S) (K/V, or MLA's compressed entries) with ``pos``
    set to each request's true prompt length."""
    _check_mixer(sub)
    a = ctx.arch
    S = x.shape[1]
    h = layers.norm_apply(p["norm1"], x, a.norm)
    if sub.mixer == "mla":
        mix, entry = mla_lib.mla_apply(p["mixer"], h, ctx.mla_cfg)
    else:
        mix, (k, v) = layers.attn_apply(p["mixer"], h, ctx.attn_cfg)
        entry = {"k": k, "v": v}
    cached = c["mixer"]
    for name, val in entry.items():
        cached[name][:, :S] = val.to(cached[name].dtype)
    cached["pos"] = lens.clone()
    x = x + mix
    if sub.ffn == "mlp":
        h = layers.norm_apply(p["norm2"], x, a.norm)
        x = x + layers.mlp_apply(p["ffn"], h, a.activation)
    elif sub.ffn == "moe":
        # decode=True: the gather path computes every token independently
        # (no capacity drops), so a packed prefill equals prefilling each
        # request alone
        h = layers.norm_apply(p["norm2"], x, a.norm)
        y, _ = _moe_block(p["ffn"], h, ctx, decode=True, layer_idx=layer_idx)
        x = x + y
    return x, c


def prefill(params, batch, ctx: ModelCtx, *, cache_len: int, lens=None):
    """Fused prefill over right-padded prompts.

    batch: {"tokens": [B, S]}; ``lens`` [B] gives each request's true
    prompt length (default S).  Returns ``(last_logits [B, V], cache)`` —
    the float32 logits at position ``lens - 1`` and a fresh cache of
    length ``cache_len`` with ``pos == lens``.
    """
    a = ctx.arch
    if "frontend" in batch:
        raise NotImplementedError("modality frontends are not ported yet")
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > cache_len:
        raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
    dev = tokens.device
    if lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lens, device=dev).to(torch.int32)
    cache = init_cache(ctx, B, cache_len, device=dev)

    x = layers.embed_apply(params["embed"], tokens)
    for i, sub in enumerate(layer_list(a)):
        x, cache[i] = _prefill_sublayer(params["layers"][i], cache[i], x, sub,
                                        ctx, lens, layer_idx=i)
    # the final norm and unembedding are row-wise: apply them to the one
    # row per request the caller needs
    last = torch.clamp(lens.long() - 1, min=0)
    x = x[torch.arange(B, device=dev), last][:, None]             # [B, 1, d]
    x = layers.norm_apply(params["final_norm"], x, a.norm)
    return layers.unembed_apply(params["embed"], x)[:, 0], cache
