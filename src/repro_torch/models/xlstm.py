"""xLSTM blocks (arXiv:2405.04517), the counterpart of
``repro/models/xlstm.py``: mLSTM (matrix memory, parallelizable) and
sLSTM (scalar memory, sequential scan with exponential gating).

xlstm-350m interleaves them 7:1 (seven mLSTM blocks, then one sLSTM
block).  mLSTM training and prefill use the stabilized parallel form (the
D matrix, ``-inf`` above its diagonal) or, with ``chunk_size``, the
chunkwise form that carries ``(C, n, m)`` from chunk to chunk; decode
keeps the ``(C, n, m)`` recurrent state.  sLSTM runs a Python loop over
time where the reference scans.  Plain PyTorch throughout: the
reference's xLSTM reaches no Pallas kernel.  The decodes return fresh
states, as the reference's do.

Tensor parallelism (``tp``): both mixers are split by heads
(``cfg.shards`` ranks, ``cfg.local_heads`` a rank), with one collective
a block forward.  The mLSTM computes the whole ``xu`` half of ``w_up``
on every rank (its q, k, v and gates read all of it) and passes it
``copy_to_model``; ``wq``/``wk``/``wv`` hold the rank's head columns,
``w_if`` its heads' two gate stripes, ``w_up``'s ``z`` stripe its heads'
channels, and ``w_down`` their rows, followed by one
``reduce_from_model``.  The per-head ``ln`` scale is whole and passes
``copy_to_model`` itself.  The sLSTM's ``w_gates`` and ``b_gates`` hold
the rank's heads in each of the four gate stripes, ``r_gates`` its heads
and ``w_out`` their rows; its ``ln`` is an RMSNorm over all of ``d``, so
the sum of squares of the rank's channels is summed over the model axis
(forward and backward) before the rank scales its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding import copy_to_model, reduce_from_model


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    num_heads: int = 4
    proj_factor: float = 2.0      # mLSTM up-projection
    slstm_every: int = 8          # one sLSTM per this many blocks
    dtype: torch.dtype = torch.bfloat16
    chunk_size: int = 0           # > 0: chunkwise mLSTM, O(S * chunk)
                                  # memory instead of the O(S^2) D matrix
    shards: int = 1               # model ranks splitting the heads

    @property
    def d_inner(self):
        return int(self.d_model * self.proj_factor)

    @property
    def local_heads(self):
        """The heads of one model rank."""
        return self.num_heads // self.shards

    @property
    def head_dim(self):
        return self.d_inner // self.num_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg: XLSTMConfig, generator, device="cuda"):
    d, di, H = cfg.d_model, cfg.d_inner, cfg.num_heads
    s, si = 1 / np.sqrt(d), 1 / np.sqrt(di)

    def normal(shape, scale):
        return layers._normal(shape, scale, generator, device).to(cfg.dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up": normal((d, 2 * di), s),
        "wq": normal((di, di), si),
        "wk": normal((di, di), si),
        "wv": normal((di, di), si),
        "w_if": normal((di, 2 * H), si),
        "b_if": torch.cat([torch.zeros((H,), **f32),
                           torch.full((H,), 3.0, **f32)]),
        "ln": {"scale": torch.ones((cfg.head_dim,), **f32)},
        "w_down": normal((di, d), si),
    }


def _mlstm_up(params, x, cfg: XLSTMConfig, tp):
    """``(xu, z)`` [B, S, di] and [B, S, di / shards]: the up-projection;
    under ``tp`` the whole ``xu`` (into the rank's heads through
    ``copy_to_model``) and the rank's heads' ``z``."""
    if tp is None:
        return (x @ params["w_up"]).chunk(2, dim=-1)
    di = cfg.d_inner
    w = params["w_up"]
    return (copy_to_model(x @ w[:, :di], tp),
            copy_to_model(x, tp) @ w[:, di:])


def _head_norm(params, y, tp):
    """The mLSTM's per-head RMSNorm; under ``tp`` its whole scale's
    gradient is summed over the ranks' heads."""
    return layers.norm_apply({"scale": copy_to_model(params["scale"], tp)},
                             y, "rmsnorm")


def _mlstm_gates(params, xu, H):
    """Input-gate preactivation and log forget gate, float32 [..., H]."""
    g = (xu @ params["w_if"]).to(torch.float32) + params["b_if"]
    return g[..., :H], F.logsigmoid(g[..., H:])


def _mlstm_qkv(params, xu, shape, hd):
    q = (xu @ params["wq"]).reshape(shape)
    k = (xu @ params["wk"]).reshape(shape) / np.sqrt(hd)
    v = (xu @ params["wv"]).reshape(shape)
    return q, k, v


def mlstm_apply(params, x, cfg: XLSTMConfig, tp=None):
    """Parallel mLSTM (chunkwise when ``cfg.chunk_size`` divides S and is
    smaller).  x: [B, S, d] -> [B, S, d]."""
    B, S, _ = x.shape
    H, hd = cfg.local_heads, cfg.head_dim
    xu, z = _mlstm_up(params, x, cfg, tp)
    q, k, v = (t.to(torch.float32)
               for t in _mlstm_qkv(params, xu, (B, S, H, hd), hd))
    i_pre, logf = _mlstm_gates(params, xu, H)            # [B, S, H]
    ck = cfg.chunk_size
    if ck and ck < S and S % ck == 0:
        num, den, m_t = _mlstm_chunkwise(q, k, v, i_pre, logf, ck)
        y = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    else:
        Fc = torch.cumsum(logf, dim=1)                   # sum of log f to t
        # D[t, s] = F_t - F_s + i_s for s <= t, -inf above the diagonal
        dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + i_pre[:, None, :, :]
        tri = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
        m = dmat.amax(dim=2, keepdim=True)               # [B, t, 1, H]
        dexp = torch.exp(dmat - m)                       # stabilized
        w = torch.einsum("bthd,bshd->btsh", q, k) * dexp
        denom = torch.maximum(w.sum(dim=2, keepdim=True).abs(),
                              torch.exp(-m))             # [B, t, 1, H]
        y = torch.einsum("btsh,bshd->bthd", w / denom, v)
    y = _head_norm(params["ln"], y, tp).reshape(B, S, -1)
    y = y.to(x.dtype) * F.silu(z)
    return reduce_from_model(y @ params["w_down"], tp)


def _mlstm_chunkwise(q, k, v, i_pre, logf, chunk: int):
    """Chunkwise-parallel mLSTM: quadratic inside a chunk, the ``(C, n,
    m)`` state carried across chunks; the parallel form's stabilized
    exponential gating.  q, k, v: [B, S, H, hd] float32 (k pre-scaled by
    1 / sqrt(hd)); i_pre, logf: [B, S, H].  Returns the unnormalized
    numerator [B, S, H, hd], denominator and stabilizer [B, S, H]."""
    B, S, H, hd = q.shape
    dev = q.device
    C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m0 = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    nums, dens, ms = [], [], []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qj, kj, vj, ij = q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl]
        Fc = torch.cumsum(logf[:, sl], dim=1)            # [B, ck, H]
        dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + ij[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
        m_inter = Fc + m0[:, None, :]
        m_t = torch.maximum(dmat.amax(dim=2), m_inter)
        wts = (torch.einsum("bthd,bshd->btsh", qj, kj)
               * torch.exp(dmat - m_t[:, :, None, :]))
        num = torch.einsum("btsh,bshd->bthd", wts, vj)
        den = wts.sum(dim=2)                              # [B, ck, H]
        # the carried state's share
        w_inter = torch.exp(m_inter - m_t)
        num = num + w_inter[..., None] * torch.einsum("bthd,bhde->bthe",
                                                      qj, C0)
        den = den + w_inter * torch.einsum("bthd,bhd->bth", qj, n0)
        # the state at the chunk's end
        F_T = Fc[:, -1]                                   # [B, H]
        g = F_T[:, None, :] - Fc + ij                     # [B, ck, H]
        m_up = torch.maximum(F_T + m0, g.amax(dim=1))
        wk = torch.exp(g - m_up[:, None, :])
        decay = torch.exp(F_T + m0 - m_up)
        C0 = (decay[..., None, None] * C0
              + torch.einsum("bsh,bshd,bshe->bhde", wk, kj, vj))
        n0 = decay[..., None] * n0 + torch.einsum("bsh,bshd->bhd", wk, kj)
        m0 = m_up
        nums.append(num)
        dens.append(den)
        ms.append(m_t)
    return torch.cat(nums, 1), torch.cat(dens, 1), torch.cat(ms, 1)


def init_mlstm_state(batch: int, cfg: XLSTMConfig, device="cuda"):
    H, hd = cfg.local_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


def mlstm_decode(params, x, state, cfg: XLSTMConfig, tp=None):
    """Recurrent step.  x: [B, 1, d] -> ([B, 1, d], fresh state)."""
    B = x.shape[0]
    H, hd = cfg.local_heads, cfg.head_dim
    xu, z = _mlstm_up(params, x, cfg, tp)
    q, k, v = (t.to(torch.float32)
               for t in _mlstm_qkv(params, xu, (B, H, hd), hd))
    i_pre, logf = _mlstm_gates(params, xu, H)
    i_pre, logf = i_pre[:, 0], logf[:, 0]                # [B, H]
    m_new = torch.maximum(logf + state["m"], i_pre)
    fg = torch.exp(logf + state["m"] - m_new)[..., None]
    ig = torch.exp(i_pre - m_new)[..., None]
    C = fg[..., None] * state["C"] + ig[..., None] * (k[..., None]
                                                      * v[..., None, :])
    n = fg * state["n"] + ig * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))[..., None]
    y = _head_norm(params["ln"], num / den, tp)
    y = y.reshape(B, 1, -1).to(x.dtype) * F.silu(z)
    return (reduce_from_model(y @ params["w_down"], tp),
            {"C": C, "n": n, "m": m_new})


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg: XLSTMConfig, generator, device="cuda"):
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    s = 1 / np.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_gates": layers._normal((d, 4 * d), s, generator,
                                  device).to(cfg.dtype),
        "r_gates": layers._normal((H, hd, 4 * hd), 1 / np.sqrt(hd),
                                  generator, device),
        "b_gates": torch.zeros((4 * d,), **f32),
        "ln": {"scale": torch.ones((d,), **f32)},
        "w_out": layers._normal((d, d), s, generator, device).to(cfg.dtype),
    }


def _channel_norm(params, hs, d: int, tp, eps: float = 1e-5):
    """The sLSTM's RMSNorm over all ``d`` channels of ``hs`` [B, S, d /
    shards] under ``tp``: the rank's sum of squares summed over the model
    axis, forward and backward (every rank's channels read it)."""
    xf = hs.to(torch.float32)
    sq = torch.sum(xf * xf, -1, keepdim=True)
    sq = copy_to_model(reduce_from_model(sq, tp), tp)
    return (xf * torch.rsqrt(sq / d + eps) * params["scale"]).to(hs.dtype)


def slstm_apply(params, x, cfg: XLSTMConfig, state=None, tp=None):
    """Sequential sLSTM over time.  x: [B, S, d] -> ([B, S, d], state)."""
    B, S, d = x.shape
    H = cfg.local_heads
    hd = d // cfg.num_heads
    wx = ((copy_to_model(x, tp) @ params["w_gates"]).to(torch.float32)
          + params["b_gates"])
    wx = wx.reshape(B, S, 4, H, hd)
    if state is None:
        state = init_slstm_state(B, cfg, x.device)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h, params["r_gates"])
        rec = rec.reshape(B, H, 4, hd).transpose(1, 2)   # [B, 4, H, hd]
        z_pre, i_pre, f_pre, o_pre = (wx[:, t, g] + rec[:, g]
                                      for g in range(4))
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        ig = torch.exp(i_pre - m_new)
        fg = torch.exp(logf + m - m_new)
        c = fg * c + ig * torch.tanh(z_pre)
        n = fg * n + ig
        h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(B, S, H * hd)
    if tp is None:
        y = layers.norm_apply(params["ln"], hs, "rmsnorm").to(x.dtype)
    else:
        y = _channel_norm(params["ln"], hs, d, tp).to(x.dtype)
    return (reduce_from_model(y @ params["w_out"], tp),
            {"c": c, "n": n, "h": h, "m": m})


def init_slstm_state(batch: int, cfg: XLSTMConfig, device="cuda"):
    H = cfg.local_heads
    hd = cfg.d_model // cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "h": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H, hd), -1e30, **f32)}


def slstm_decode(params, x, state, cfg: XLSTMConfig, tp=None):
    return slstm_apply(params, x, cfg, state, tp)
