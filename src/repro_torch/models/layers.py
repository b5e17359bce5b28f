"""Shared transformer building blocks (the counterpart of
``repro/models/layers.py``).

Conventions match the reference: params are plain dicts of tensors;
``init_*`` builds them from an explicit ``torch.Generator`` on an explicit
device, ``*_apply`` consumes them.  Norms and softmax run in float32 and
cast back; the attention mask value is -1e30; RoPE pairs are interleaved
(``x[..., ::2]`` / ``x[..., 1::2]``); gelu is the tanh form; unembedding
runs in float32.

``attn_decode`` writes the new K/V row into the cache tensors in place
(the reference returns fresh arrays); the returned cache holds the same
tensors with ``pos`` advanced.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _normal(shape, scale, generator, device):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, d: int, device="cuda"):
    if kind == "nonparam_ln":
        return {}
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    raise ValueError(kind)


def norm_apply(params, x, kind: str, eps: float = 1e-5):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        y = y * params["scale"]
    else:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device):
    """float32 [head_dim / 2] inverse frequencies on ``device``, computed
    in float64 once per (head_dim, theta, device): later calls cost no
    launch and no host-to-device copy.  Read-only."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return (1.0 / (theta ** exps)).to(torch.float32)


def apply_rope(x, positions, theta: float = 1e4):
    """x: [..., S, H, hd]; positions: [..., S].  Interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    sliding_window: int = 0      # 0 = full attention
    causal: bool = True
    qkv_bias: bool = False
    dtype: torch.dtype = torch.bfloat16
    use_flash_kernel: bool = False
    use_blockwise: bool = False      # online softmax over key blocks


def init_attn(cfg: AttnConfig, generator, device="cuda"):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    p = {
        "wq": _normal((d, H * hd), s, generator, device).to(cfg.dtype),
        "wk": _normal((d, K * hd), s, generator, device).to(cfg.dtype),
        "wv": _normal((d, K * hd), s, generator, device).to(cfg.dtype),
        "wo": _normal((H * hd, d), 1.0 / np.sqrt(H * hd), generator,
                      device).to(cfg.dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((width,), dtype=cfg.dtype, device=device)
    return p


def _qkv(params, x, cfg: AttnConfig):
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, K, hd),
            v.reshape(B, S, K, hd))


def _sdpa(q, k, v, *, causal, sliding_window, q_positions, k_positions):
    """Reference scaled-dot-product attention with GQA + optional window.
    q: [B, Sq, H, hd]; k/v: [B, Sk, K, hd] -> [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = (q.to(torch.float32) / np.sqrt(hd)).reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32))
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_positions[:, None] >= k_positions[None, :]
    if sliding_window:
        mask &= (q_positions[:, None] - k_positions[None, :]) < sliding_window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _blockwise_sdpa(q, k, v, *, causal, sliding_window, block_k: int = 1024):
    """Online-softmax attention over key blocks of ``block_k`` rows: the
    [Sq, Sk] score matrix is never held whole, only [Sq, block_k] of it
    (the reference's ``_blockwise_sdpa``, a loop where it scans).  q: [B,
    Sq, H, hd]; k: [B, Sk, K, hd]; v: [B, Sk, K, hdv], where hdv may differ
    from hd (MLA).  Positions are ``arange`` on both sides."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // K
    bk = min(block_k, Sk)
    dev = q.device
    qf = (q.to(torch.float32) / np.sqrt(hd)).reshape(B, Sq, K, G, hd)
    qpos = torch.arange(Sq, device=dev)
    o = torch.zeros((B, K, G, Sq, hdv), dtype=torch.float32, device=dev)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    for j0 in range(0, Sk, bk):
        kj = k[:, j0:j0 + bk].to(torch.float32)
        vj = v[:, j0:j0 + bk].to(torch.float32)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kj)
        kpos = torch.arange(j0, j0 + kj.shape[1], device=dev)
        mask = torch.ones((Sq, kj.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if sliding_window:
            mask &= (qpos[:, None] - kpos[None, :]) < sliding_window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vj)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    o = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hdv)
    return o.to(q.dtype)


def attn_apply(params, x, cfg: AttnConfig, positions=None):
    """Full-sequence (prefill) attention.  x: [B, S, d] -> (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.use_flash_kernel:
        from repro_torch.kernels.flash_attn import ops as fa_ops
        out = fa_ops.flash_attention(q, k, v, causal=cfg.causal,
                                     sliding_window=cfg.sliding_window)
    elif cfg.use_blockwise:
        out = _blockwise_sdpa(q, k, v, causal=cfg.causal,
                              sliding_window=cfg.sliding_window)
    else:
        out = _sdpa(q, k, v, causal=cfg.causal,
                    sliding_window=cfg.sliding_window,
                    q_positions=positions, k_positions=positions)
    return out.reshape(B, S, -1) @ params["wo"], (k, v)


def attn_decode(params, x, cache, cfg: AttnConfig):
    """Single-token decode vs a KV cache, updated in place.

    x: [B, 1, d]; cache: {"k": [B, L, K, hd], "v": ..., "pos": [B]}.
    Returns ``(out [B, 1, d], cache)`` with row ``pos`` of k/v written and
    ``pos`` advanced by one.
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, cfg)
    pos = cache["pos"]
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    L = k.shape[1]
    rows = torch.arange(B, device=x.device)
    k[rows, pos.long()] = k_new[:, 0].to(k.dtype)
    v[rows, pos.long()] = v_new[:, 0].to(v.dtype)
    k_positions = torch.arange(L, device=x.device)
    valid = k_positions[None, :] <= pos[:, None]               # [B, L]
    if cfg.sliding_window:
        valid &= (pos[:, None] - k_positions[None, :]) < cfg.sliding_window
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    qg = (q.to(torch.float32) / np.sqrt(hd)).reshape(B, K, G, hd)
    logits = torch.einsum("bkgh,blkh->bkgl", qg, k.to(torch.float32))
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgl,blkh->bkgh", w, v.to(torch.float32))
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ params["wo"], {"k": k, "v": v, "pos": pos + 1}


def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig, device="cuda"):
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, K, hd), dtype=cfg.dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, K, hd), dtype=cfg.dtype,
                             device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------


def init_mlp(d: int, f: int, activation: str, dtype, generator,
             device="cuda"):
    s1, s2 = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    p = {"w_in": _normal((d, f), s1, generator, device).to(dtype),
         "w_out": _normal((f, d), s2, generator, device).to(dtype)}
    if activation == "swiglu":
        p["w_gate"] = _normal((d, f), s1, generator, device).to(dtype)
    return p


def mlp_apply(params, x, activation: str):
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_in"])
    else:
        h = F.gelu(x @ params["w_in"], approximate="tanh")
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embed(vocab: int, d: int, dtype, generator, device="cuda"):
    return {"table": (_normal((vocab, d), 1.0, generator, device)
                      .to(dtype) * 0.02)}


def embed_apply(params, tokens):
    return params["table"][tokens.long()]


def unembed_apply(params, x):
    """Logits in float32."""
    return x.to(torch.float32) @ params["table"].to(torch.float32).T
