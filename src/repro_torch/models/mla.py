"""DeepSeek-V2 Multi-head Latent Attention (the counterpart of
``repro/models/mla.py``).

Training and prefill use the expanded form (:func:`mla_apply`); decode
uses the absorbed form (:func:`mla_decode`), which keeps only the
compressed latent cache: ``kv_lora_rank + qk_rope_dim`` values a token
instead of a key and a value a head.  Both run plain PyTorch, as the
reference computes them outside any Pallas kernel: MLA's qk dim (192)
differs from its v dim (128), which the flash kernel does not take.

``mla_decode`` writes the new latent row into the cache tensors in
place (the reference returns fresh arrays), as ``layers.attn_decode``
does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    q_lora_rank: int = 0          # 0 = full-rank q projection
    rope_theta: float = 1e4
    dtype: torch.dtype = torch.bfloat16
    use_blockwise: bool = False   # online softmax over key blocks

    @property
    def qk_dim(self):
        return self.qk_nope_dim + self.qk_rope_dim


def init_mla(cfg: MLAConfig, generator, device="cuda"):
    d, H = cfg.d_model, cfg.num_heads
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    dv = cfg.v_dim
    s = 1.0 / np.sqrt(d)

    def normal(shape, scale):
        return layers._normal(shape, scale, generator, device).to(cfg.dtype)

    p = {
        "w_dkv": normal((d, r), s),
        "w_uk": normal((r, H, dn), 1 / np.sqrt(r)),
        "w_uv": normal((r, H, dv), 1 / np.sqrt(r)),
        "w_kr": normal((d, dr), s),
        "w_o": normal((H * dv, d), 1 / np.sqrt(H * dv)),
        "kv_norm": layers.init_norm("rmsnorm", r, device),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = normal((d, cfg.q_lora_rank), s)
        p["w_uq"] = normal((cfg.q_lora_rank, H, cfg.qk_dim),
                           1 / np.sqrt(cfg.q_lora_rank))
        p["q_norm"] = layers.init_norm("rmsnorm", cfg.q_lora_rank, device)
    else:
        p["w_q"] = normal((d, H, cfg.qk_dim), s)
    return p


def _q_proj(params, x, cfg: MLAConfig):
    """x [B, S, d] -> q [B, S, H, qk_dim], through the low-rank branch
    (``w_dq``, ``q_norm``, ``w_uq``) when ``q_lora_rank`` > 0."""
    if cfg.q_lora_rank:
        cq = layers.norm_apply(params["q_norm"], x @ params["w_dq"],
                               "rmsnorm")
        return torch.einsum("bsr,rhd->bshd", cq, params["w_uq"])
    return torch.einsum("bsd,dhe->bshe", x, params["w_q"])


def mla_apply(params, x, cfg: MLAConfig, positions=None):
    """Expanded-form MLA for training and prefill.  x: [B, S, d] ->
    ``(out [B, S, d], {"c_kv": [B, S, r], "k_rope": [B, S, dr]})``, the
    second the entries a decode cache keeps."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)

    q = _q_proj(params, x, cfg)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = layers.norm_apply(params["kv_norm"], x @ params["w_dkv"],
                             "rmsnorm")
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhd->bshd", c_kv, params["w_uv"])
    k_rope = layers.apply_rope((x @ params["w_kr"])[:, :, None, :],
                               positions, cfg.rope_theta)    # [B, S, 1, dr]

    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], -1)
    if cfg.use_blockwise:
        out = layers._blockwise_sdpa(qf, kf, v, causal=True,
                                     sliding_window=0).to(torch.float32)
    else:
        scale = 1.0 / np.sqrt(cfg.qk_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk",
                              qf.to(torch.float32) * scale,
                              kf.to(torch.float32))
        mask = positions[:, None] >= positions[None, :]
        logits = torch.where(mask, logits, layers.NEG_INF)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v.to(torch.float32))
    out = out.reshape(B, S, H * dv).to(x.dtype) @ params["w_o"]
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}


def init_mla_cache(batch: int, max_len: int, cfg: MLAConfig, device="cuda"):
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=cfg.dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=cfg.dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def mla_decode(params, x, cache, cfg: MLAConfig):
    """Absorbed-form one-token decode against the compressed cache,
    updated in place.

    logits_h(l) = q_abs_h . c_kv(l) + q_rope_h . k_rope(l), with q_abs_h =
    q_nope_h @ w_uk_h: the key up-projection is absorbed into the query,
    so attention runs in the rank-r latent space, and the value
    up-projection is applied once to the attended latent.  x: [B, 1, d];
    returns ``(out [B, 1, d], cache)`` with row ``pos`` of ``c_kv`` and
    ``k_rope`` written and ``pos`` advanced by one.
    """
    B = x.shape[0]
    dn = cfg.qk_nope_dim
    pos = cache["pos"]

    q = _q_proj(params, x, cfg)[:, 0]                     # [B, H, qk_dim]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope[:, None], pos[:, None],
                               cfg.rope_theta)[:, 0]

    c_new = layers.norm_apply(params["kv_norm"], x[:, 0] @ params["w_dkv"],
                              "rmsnorm")
    kr_new = layers.apply_rope((x[:, 0] @ params["w_kr"])[:, None, None, :],
                               pos[:, None], cfg.rope_theta)[:, 0, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    rows = torch.arange(B, device=x.device)
    c_kv[rows, pos.long()] = c_new.to(c_kv.dtype)
    k_rope[rows, pos.long()] = kr_new.to(k_rope.dtype)

    q_abs = torch.einsum("bhd,rhd->bhr", q_nope, params["w_uk"])   # [B,H,r]
    scale = 1.0 / np.sqrt(cfg.qk_dim)
    logits = (torch.einsum("bhr,blr->bhl", q_abs.to(torch.float32),
                           c_kv.to(torch.float32))
              + torch.einsum("bhd,bld->bhl", q_rope.to(torch.float32),
                             k_rope.to(torch.float32))) * scale
    L = c_kv.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] <= pos[:, None]
    logits = torch.where(valid[:, None, :], logits, layers.NEG_INF)
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhl,blr->bhr", w, c_kv.to(torch.float32))
    out = torch.einsum("bhr,rhd->bhd", ctx,
                       params["w_uv"].to(torch.float32))
    out = out.reshape(B, 1, -1).to(x.dtype) @ params["w_o"]
    return out, {"c_kv": c_kv, "k_rope": k_rope, "pos": pos + 1}
