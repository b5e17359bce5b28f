"""Mamba (S6) selective-state-space block (the counterpart of
``repro/models/mamba.py``), used by the Jamba hybrid.

Training and prefill run the selective scan in parallel over time: a
log-depth (Hillis–Steele) scan of :func:`_combine` over the time axis,
``ceil(log2 S)`` elementwise rounds over the float32 ``(a, b)`` pair, the
associative recursion ``jax.lax.associative_scan`` evaluates in the
reference.  Decode is the O(1) recurrent step on carried state.  Plain
PyTorch throughout: the reference's Mamba reaches no Pallas kernel.

``mamba_decode`` returns a fresh state, as the reference does (the
attention and MLA decodes write their caches in place).

Tensor parallelism (``tp``): the block is split over its inner channels
``d_inner`` (``cfg.shards`` ranks).  A rank's ``w_in`` holds its slice of
the ``x`` stripe beside its slice of the ``z`` stripe, and its conv,
``w_dt``, ``b_dt``, ``A_log``, ``D`` and the rows of ``w_out`` follow the
same channels, as does the carried decode state.  ``w_x_dbc`` reduces
over every channel, so it is split by rows: its ``[B, S, rk + 2n]``
product is summed over the model axis before ``dt``, ``B`` and ``C``
(one all-reduce), and passes ``copy_to_model`` into the rank's
channels.  ``w_out``'s product ends in one ``reduce_from_model``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding import copy_to_model, reduce_from_model


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    dtype: torch.dtype = torch.bfloat16
    scan_chunk: int = 0        # > 0: the scan a chunk at a time, the state
                               # carried between chunks (bounds the f32
                               # working set to O(chunk * d_inner * d_state))
    shards: int = 1            # model ranks splitting d_inner

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def d_inner_local(self):
        """The inner channels of one model rank."""
        return self.d_inner // self.shards

    @property
    def dt_rank_(self):
        return self.dt_rank or -(-self.d_model // 16)


def init_mamba(cfg: MambaConfig, generator, device="cuda"):
    d, di, n, rk = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank_

    def normal(shape, scale):
        return layers._normal(shape, scale, generator, device).to(cfg.dtype)

    A = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "w_in": normal((d, 2 * di), 1.0 / np.sqrt(d)),
        "conv_w": normal((cfg.d_conv, di), 1.0 / np.sqrt(cfg.d_conv)),
        "conv_b": torch.zeros((di,), dtype=cfg.dtype, device=device),
        "w_x_dbc": normal((di, rk + 2 * n), 1.0 / np.sqrt(di)),
        "w_dt": normal((rk, di), 1.0 / np.sqrt(rk)),
        "b_dt": torch.log(torch.expm1(torch.full(
            (di,), 0.01, dtype=torch.float32, device=device))),
        "A_log": torch.log(A),                             # [di, n] f32
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "w_out": normal((di, d), 1.0 / np.sqrt(di)),
    }


def _conv_causal(x, w, b, state=None):
    """Depthwise causal conv.  x: [B, S, di]; w: [K, di]; ``state`` the
    previous K - 1 inputs [B, K - 1, di] (zeros when None).  Returns
    ``(out, new_state)``."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out + b, new_state


def _ssm_params(params, xc, cfg: MambaConfig, tp=None):
    n, rk = cfg.d_state, cfg.dt_rank_
    dbc = xc @ params["w_x_dbc"]                       # [B, S, rk + 2n]
    if tp is not None:
        dbc = copy_to_model(reduce_from_model(dbc, tp), tp)
    dt = F.softplus(dbc[..., :rk] @ params["w_dt"] + params["b_dt"])
    Bm = dbc[..., rk:rk + n].to(torch.float32)         # [B, S, n]
    Cm = dbc[..., rk + n:].to(torch.float32)           # [B, S, n]
    A = -torch.exp(params["A_log"])                    # [di, n]
    return dt.to(torch.float32), Bm, Cm, A


def _combine(l, r):
    al, bl = l
    ar, br = r
    return al * ar, br + ar * bl


def _scan(a, b):
    """Inclusive scan of :func:`_combine` over axis 1 of ``(a, b)`` [B, S,
    ...]: round ``k`` combines each position with the one ``2^k`` before
    it (Hillis–Steele), ``ceil(log2 S)`` rounds.  Returns ``(prod a,
    h)``."""
    S = a.shape[1]
    step = 1
    while step < S:
        a_new, b_new = _combine((a[:, :-step], b[:, :-step]),
                                (a[:, step:], b[:, step:]))
        a = torch.cat([a[:, :step], a_new], dim=1)
        b = torch.cat([b[:, :step], b_new], dim=1)
        step *= 2
    return a, b


def mamba_apply(params, x, cfg: MambaConfig, tp=None):
    """x: [B, S, d] -> [B, S, d] by the parallel scan.

    With ``cfg.scan_chunk`` > 0 dividing S (and below it) the time axis
    runs a chunk at a time with the state carried between chunks: the
    scan's float32 intermediates exist for one chunk at a time."""
    B, S, _ = x.shape
    xz = copy_to_model(x, tp) @ params["w_in"]
    xc, z = xz.chunk(2, dim=-1)
    xc, _ = _conv_causal(xc, params["conv_w"], params["conv_b"])
    xc = F.silu(xc)

    dt, Bm, Cm, A = _ssm_params(params, xc, cfg, tp)
    xf = xc.to(torch.float32)
    # discretize: a_t = exp(dt * A) [B, S, di, n]; b_t = dt * B * x
    a = torch.exp(dt[..., None] * A)
    b = (dt * xf)[..., None] * Bm[:, :, None, :]

    ck = cfg.scan_chunk
    if ck and ck < S and S % ck == 0:
        h0 = torch.zeros((B,) + a.shape[2:], dtype=torch.float32,
                         device=x.device)
        hs = []
        for c0 in range(0, S, ck):
            acc, h = _scan(a[:, c0:c0 + ck], b[:, c0:c0 + ck])
            h = h + acc * h0[:, None]          # inject the carry
            h0 = h[:, -1]
            hs.append(h)
        h = torch.cat(hs, dim=1)
    else:
        _, h = _scan(a, b)
    y = torch.einsum("bsdn,bsn->bsd", h, Cm) + params["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return reduce_from_model(y @ params["w_out"], tp)


def init_mamba_state(batch: int, cfg: MambaConfig, device="cuda"):
    """Zero state of a rank's ``d_inner_local`` channels."""
    di = cfg.d_inner_local
    return {"h": torch.zeros((batch, di, cfg.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, di),
                                dtype=cfg.dtype, device=device)}


def mamba_decode(params, x, state, cfg: MambaConfig, tp=None):
    """Single-token recurrent step.  x: [B, 1, d] -> (out [B, 1, d], a
    fresh ``{"h", "conv"}`` state)."""
    xz = copy_to_model(x, tp) @ params["w_in"]
    xc, z = xz.chunk(2, dim=-1)
    xc, conv_state = _conv_causal(xc, params["conv_w"], params["conv_b"],
                                  state["conv"])
    xc = F.silu(xc)
    dt, Bm, Cm, A = _ssm_params(params, xc, cfg, tp)
    xf = xc.to(torch.float32)[:, 0]
    a = torch.exp(dt[:, 0, :, None] * A)                       # [B, di, n]
    b = (dt[:, 0] * xf)[..., None] * Bm[:, 0, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0]) + params["D"] * xf
    y = y[:, None].to(x.dtype) * F.silu(z)
    return (reduce_from_model(y @ params["w_out"], tp),
            {"h": h, "conv": conv_state.contiguous()})
