"""Public flash-attention entry with the backend policy (the counterpart of
``repro/kernels/flash_attn/ops.py``).

For CUDA tensors (with kernels wanted) :func:`flash_attention` launches
the hand-written kernel of ``csrc/flash_attn.cu``; for CPU tensors it
runs the plain :func:`ref.flash_attention_ref`.  Forward only in this
slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

KERNEL = "flash_attn.flash_attention"
#: the variants the kernel builds (csrc/flash_attn.cu instantiates one per
#: head dim): 64 for gpt3_medium_moe and granite_3_2b, 128 for olmo_1b,
#: internlm2_1_8b and minitron_4b; bf16 only
HEAD_DIMS, DTYPE = (64, 128), torch.bfloat16
_V, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=1)
def _entry():
    return backend.bind("flash_attn", "flash_attention_fwd",
                        [_V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I, _I, _V])


def _flash_cuda(q, k, v, causal: bool, sliding_window: int):
    backend.check_no_grad(KERNEL, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{KERNEL}: q, k, v must be 4-D [B, S, heads, hd]")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, K, hd) or v.shape != k.shape:
        raise ValueError(f"{KERNEL}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if K == 0 or H % K:
        raise ValueError(f"{KERNEL}: {H} query heads over {K} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head_dim {hd}; the kernel is built "
                         f"for head dims {HEAD_DIMS} only")
    if (q.dtype, k.dtype, v.dtype) != (DTYPE,) * 3:
        raise TypeError(f"{KERNEL}: q/k/v must be {DTYPE}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{KERNEL}: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{KERNEL}: {name} must be contiguous and "
                             f"16-byte aligned (the kernel copies 16-byte "
                             f"pieces)")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = _entry()(backend.ptr(q), backend.ptr(k), backend.ptr(v),
                   backend.ptr(o), B, Sq, Sk, H, K, hd, int(bool(causal)),
                   int(sliding_window), backend.stream_ptr(q.device))
    backend.check(KERNEL, err)
    backend.record_launch(KERNEL)
    return o


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    use_pallas=None):
    """q: [B, Sq, H, hd]; k/v: [B, Sk, K, hd] -> [B, Sq, H, hd] in q's
    dtype.  The CUDA kernel takes bfloat16 with hd 64 or 128 and raises
    on anything else; the plain version (CPU tensors) takes any."""
    if not backend.kernels_active(use_pallas, q.device):
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    return _flash_cuda(q, k, v, causal, sliding_window)


# ---------------------------------------------------------------------------
# launch layouts (backend.register_kernel; csrc/flash_attn.cu's geometry)
# ---------------------------------------------------------------------------

#: csrc/flash_attn.cu: 64 query rows a block in 4 warps (its launch bound);
#: dynamic shared memory Q, then two K and two V stages of 64 rows of bf16
BQ, BKV, THREADS = 64, 64, 128


def flash_launch(B: int, Sq: int, H: int, K: int,
                 hd: int) -> backend.LaunchDecl:
    """K5's launch: (query block, head, request); head ``h`` reads KV
    head ``h // (H / K)``."""
    gx = -(-Sq // BQ)
    return backend.LaunchDecl(
        f"flash_attn_kernel<{hd}>", (gx, H, B), THREADS,
        (BQ + 4 * BKV) * hd * 2, 0, THREADS,
        spans=(backend.Span("q rows", Sq, *backend.blocks(gx, BQ, Sq)),
               backend.Span("kv heads", K, tuple(h // (H // K)
                                                 for h in range(H)),
                            (1,) * H)),
        writes=(backend.Write("o", lambda x, y, z: (
            x * BQ, min(Sq, (x + 1) * BQ), (y, z))),))


#: (label, B, Sq, H, K, hd): the serve prefill packs of gpt3_medium_moe
#: (4 x 128, 16 heads of 64) and of the dense decoders at hd 128, the
#: training length, Whisper's encoder, InternVL2's GQA 6:1 prefill, and a
#: model rank's heads on a tensor-parallel world of 2
#: (``layouts.TP_MODEL``): gpt3's 8 of 16, Minitron-4B's 12 of 24 over 4
#: of 8 KV heads, Whisper's encoder 3 of 6, InternVL2's 24 of 48 over 4 of
#: 8 KV heads
SHAPES = (("serve_prefill", 4, 128, 16, 16, 64),
          ("S512", 4, 512, 16, 16, 64),
          ("dense_prefill_hd128", 4, 128, 16, 16, 128),
          ("S512_hd128_kv8", 4, 512, 16, 8, 128),
          ("whisper_encoder", 4, 1500, 6, 6, 64),
          ("internvl2_prefill", 4, 384, 48, 8, 128),
          ("tp2_gpt3_prefill", 4, 128, 8, 8, 64),
          ("tp2_minitron_prefill", 4, 128, 12, 4, 128),
          ("tp2_whisper_encoder", 4, 1500, 3, 3, 64),
          ("tp2_internvl2_prefill", 4, 384, 24, 4, 128))


@backend.register_kernel(KERNEL)
def _flash_layouts():
    return [backend.KernelLayout(
        f"{KERNEL}[{label} [{B}, {Sq}, {H}, {hd}] kv {K}]",
        (flash_launch(B, Sq, H, K, hd),),
        meta={"geometry": ("flash_attn", "flash_attention_geometry",
                           (B, Sq, H, hd))})
        for label, B, Sq, H, K, hd in SHAPES]
