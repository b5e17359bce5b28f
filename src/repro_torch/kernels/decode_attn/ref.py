"""Plain PyTorch version of decode attention (the counterpart of
``repro/kernels/decode_attn/ref.py``): one query token a request against
a [B, L, K, hd] KV cache, float32 inside, q scaled by ``1/sqrt(hd)``,
query head ``h`` reading KV head ``h // (H // K)``.

Rows of a request outside ``[lengths - sliding_window, lengths)`` get
weight 0, and their v values are not read into the sum: a cache may hold
anything there, NaN included (the TPU kernel zeroes them the same way).
A request with no valid row (``lengths == 0``) keeps the reference's
arithmetic: a softmax over a row of ``-1e30`` is uniform, so it returns
the mean of every v row of the request.  The CUDA kernel returns zeros
there instead, as the TPU kernel does (``csrc/decode_attn.cu``).
"""

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, lengths, *, sliding_window: int = 0):
    """q: [B, H, hd]; k/v: [B, L, K, hd]; lengths: [B] -> [B, H, hd] in
    q's dtype."""
    B, H, hd = q.shape
    L, K = k.shape[1], k.shape[2]
    G = H // K
    qg = (q.to(torch.float32) / math.sqrt(hd)).reshape(B, K, G, hd)
    s = torch.einsum("bkgh,blkh->bkgl", qg, k.to(torch.float32))
    kpos = torch.arange(L, device=q.device)
    lens = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    mask = kpos[None, :] < lens                                 # [B, L]
    if sliding_window:
        mask &= kpos[None, :] >= (lens - sliding_window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    read = mask | ~mask.any(dim=1, keepdim=True)
    vf = torch.where(read[:, :, None, None], v.to(torch.float32), 0.0)
    out = torch.einsum("bkgl,blkh->bkgh", w, vf)
    return out.reshape(B, H, hd).to(q.dtype)
