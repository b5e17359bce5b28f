"""Public decode-attention entry with the backend policy (the counterpart
of ``repro/kernels/decode_attn/ops.py``).

For CUDA tensors (with kernels wanted) :func:`decode_attention` launches
the split kernel and its combine of ``csrc/decode_attn.cu`` (K8); for CPU
tensors it runs the plain :func:`ref.decode_attention_ref`.  Forward only,
as the reference's entry is.  No model calls it: the decode path's
attention is the plain ``layers.attn_decode``, as in the reference.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

KERNEL = "decode_attn.decode_attention"
#: the variants the kernel builds (csrc/decode_attn.cu instantiates one per
#: head dim), in bf16
HEAD_DIMS, DTYPE = (64, 128), torch.bfloat16
#: query heads one KV head may serve (H // K)
MAX_GROUP = 16
_V, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=1)
def _entry():
    lib = backend.load("decode_attn")
    rows = lib.decode_attn_split_rows
    rows.argtypes, rows.restype = [], ctypes.c_int
    f = backend.bind("decode_attn", "decode_attention_fwd",
                     [_V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I,
                      _I, _V])
    return f, rows()


def _decode_cuda(q, k, v, lengths, sliding_window: int):
    backend.check_no_grad(KERNEL, q, k, v)
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4 or lengths.dim() != 1:
        raise ValueError(f"{KERNEL}: q [B, H, hd], k/v [B, L, K, hd] and "
                         f"lengths [B] expected")
    B, H, hd = q.shape
    L, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, L, K, hd) or v.shape != k.shape \
            or lengths.shape[0] != B:
        raise ValueError(f"{KERNEL}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} disagree")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"{KERNEL}: {H} query heads over {K} kv heads "
                         f"(at most {MAX_GROUP} a kv head)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head_dim {hd}; the kernel is built "
                         f"for head dims {HEAD_DIMS} only")
    if (q.dtype, k.dtype, v.dtype) != (DTYPE,) * 3:
        raise TypeError(f"{KERNEL}: q/k/v must be {DTYPE}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{KERNEL}: lengths must be int32, got "
                        f"{lengths.dtype}")
    if sliding_window < 0:
        raise ValueError(f"{KERNEL}: sliding_window {sliding_window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{KERNEL}: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{KERNEL}: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn, split_rows = _entry()
    n_split = max(1, -(-L // split_rows))
    o_part = torch.empty((B, H, n_split, hd), dtype=torch.float32,
                         device=q.device)
    ml_part = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                          device=q.device)
    err = fn(backend.ptr(q), backend.ptr(k), backend.ptr(v),
             backend.ptr(lengths), backend.ptr(o_part), backend.ptr(ml_part),
             backend.ptr(out), B, L, H, K, hd, int(sliding_window), n_split,
             backend.stream_ptr(q.device))
    backend.check(KERNEL, err)
    backend.record_launch(KERNEL)
    return out


def decode_attention(q, k, v, lengths, *, sliding_window: int = 0):
    """q: [B, H, hd]; k/v: [B, L, K, hd]; lengths: [B] valid entries ->
    [B, H, hd] in q's dtype.  The CUDA kernel takes bfloat16 with hd 64 or
    128 and int32 lengths, raises on anything else, and returns zeros for a
    request with no valid row; the plain version (CPU tensors) takes any."""
    if not backend.kernels_active(None, q.device):
        return decode_attention_ref(q, k, v, lengths,
                                    sliding_window=sliding_window)
    return _decode_cuda(q, k, v, lengths, int(sliding_window))


# ---------------------------------------------------------------------------
# launch layouts (backend.register_kernel; csrc/decode_attn.cu's geometry)
# ---------------------------------------------------------------------------

#: csrc/decode_attn.cu: SPLIT_ROWS cache rows a split block of 4 warps (its
#: launch bound), each warp streaming steps of 32 / (hd / 32) rows through
#: its own ring of 3 stages of 4 KB (dynamic shared memory, opted into),
#: with the pre-scaled queries of the heads a warp keeps state for in a
#: static f32 Qs[heads][hd]; the combine runs one thread an output
#: dimension
SPLIT_ROWS, THREADS = 512, 128
SPLIT_SMEM = 4 * 3 * 4096


def state_heads(G: int) -> int:
    """The query heads a warp of the split launch keeps state for (its
    instantiation) at G query heads a KV head."""
    return 4 if G <= 4 else MAX_GROUP


def split_static(hd: int, G: int) -> int:
    return backend.static_smem(4 * state_heads(G) * hd)


def decode_launches(B: int, L: int, H: int, K: int, hd: int) -> tuple:
    """K8's two launches: the splits over (KV head, split, request), then
    the combine over (request, query head)."""
    n_split = max(1, -(-L // SPLIT_ROWS))
    G = H // K
    split = backend.LaunchDecl(
        f"decode_split_kernel<{hd},{state_heads(G)}>", (K, n_split, B),
        THREADS, SPLIT_SMEM, split_static(hd, G), THREADS,
        spans=(backend.Span("cache rows", L,
                            *backend.blocks(n_split, SPLIT_ROWS, L)),
               backend.Span("query heads a kv head", MAX_GROUP, (0,), (G,))),
        writes=(backend.Write("o_part", lambda x, y, z: (y, y + 1, (x, z))),))
    combine = backend.LaunchDecl(
        f"decode_combine_kernel<{hd}>", (B * H, 1, 1), hd, 0, 0, hd,
        spans=(backend.Span("out rows", B * H, tuple(range(B * H)),
                            (1,) * (B * H)),),
        writes=(backend.Write("out", lambda x, y, z: (x, x + 1, 0)),))
    return split, combine


#: (label, B, L, H, K, hd): the decode_32k cache of gpt3_medium_moe's
#: heads and of the dense decoders' (8 KV heads of 128), a short one, and
#: one with 16 query heads a KV head (the wide instantiation)
SHAPES = (("decode_32k", 32, 32768, 16, 16, 64),
          ("decode_32k_hd128_kv8", 32, 32768, 16, 8, 128),
          ("L1000", 4, 1000, 16, 16, 64),
          ("L1000_G16", 4, 1000, 16, 1, 128))


@backend.register_kernel(KERNEL)
def _decode_layouts():
    return [backend.KernelLayout(
        f"{KERNEL}[{label} B={B} L={L} H={H} kv {K} hd {hd}]",
        decode_launches(B, L, H, K, hd),
        meta={"geometry": ("decode_attn", "decode_attention_geometry",
                           (B, H, K, hd, max(1, -(-L // SPLIT_ROWS))))})
        for label, B, L, H, K, hd in SHAPES]
