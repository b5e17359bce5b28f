"""Public fused local-MoE entry with the backend policy (the counterpart of
``repro/kernels/moe_fused/ops.py``).

:func:`local_moe` takes the raw [T, d] token buffer, the flat slot maps
(``slot_to_token`` / ``slot_w``), the static segment layout and its
runtime ``rows_valid`` occupancy, and returns the [T, d] float32 combined
output.  For CUDA tensors (with kernels wanted) it launches the
hand-written kernel of ``csrc/moe_fused.cu``; for CPU tensors it runs the
plain :func:`ref.local_moe_ref`.  The kernel is forward-only in this
slice.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.moe_fused.ref import local_moe_ref

KERNEL = "moe_fused.local_moe"
TILE_ROWS = 64            # BM of csrc/moe_fused.cu (checked at bind time)
_V, _I = ctypes.c_void_p, ctypes.c_int


def use_fused(use_pallas=None, device="cuda") -> bool:
    """Whether the engine takes the fused branch: the shared
    ``backend.want_kernels`` decision (on the CPU a forced fused branch
    runs the plain version)."""
    return backend.want_kernels(use_pallas, device)


@functools.lru_cache(maxsize=64)
def plan_tiles(seg_offsets: tuple, seg_experts: tuple,
               rows: int = TILE_ROWS) -> np.ndarray:
    """Fixed-row tiling of a segment layout: int32 [n_tiles, 5] rows of
    (first slot, expert, segment, offset into the segment, rows in the
    tile).  Every segment is cut into ``ceil(width / rows)`` tiles; the
    last one is row-masked, so no tile straddles two segments."""
    out = []
    for s, e in enumerate(seg_experts):
        start, width = seg_offsets[s], seg_offsets[s + 1] - seg_offsets[s]
        for loc in range(0, width, rows):
            out.append((start + loc, int(e), s, loc, min(rows, width - loc)))
    return np.asarray(out, np.int32).reshape(-1, 5)


@functools.lru_cache(maxsize=64)
def _tiles_on(seg_offsets: tuple, seg_experts: tuple, device: str):
    return torch.as_tensor(plan_tiles(seg_offsets, seg_experts),
                           device=device)


@functools.lru_cache(maxsize=1)
def _entry():
    lib = backend.load("moe_fused")
    rows = lib.moe_fused_tile_rows
    rows.argtypes, rows.restype = [], ctypes.c_int
    if rows() != TILE_ROWS:
        raise RuntimeError(f"moe_fused.cu tiles {rows()} rows, the wrapper "
                           f"plans {TILE_ROWS}")
    return backend.bind("moe_fused", "local_moe_fused",
                        [_V, _I, _I, _I, _V, _V, _V, _V, _I, _V, _V, _V, _V,
                         _V, _I, _V])


def _check(name, t, dtype, device, ndim):
    if t.device != device:
        raise ValueError(f"{KERNEL}: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{KERNEL}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{KERNEL}: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{KERNEL}: {name} must be contiguous")


def _local_moe_cuda(x, slot_to_token, slot_w, offs, exps, rows_valid, w_in,
                    w_gate, w_out, swiglu: bool):
    backend.check_no_grad(KERNEL, x, slot_w, w_in, w_gate, w_out)
    dev = x.device
    T, d = x.shape
    E, d_in, f = w_in.shape
    _check("x", x, torch.bfloat16, dev, 2)
    _check("slot_to_token", slot_to_token, torch.int32, dev, 1)
    _check("slot_w", slot_w, torch.float32, dev, 1)
    _check("rows_valid", rows_valid, torch.int32, dev, 1)
    _check("w_in", w_in, torch.bfloat16, dev, 3)
    _check("w_out", w_out, torch.bfloat16, dev, 3)
    if swiglu:
        _check("w_gate", w_gate, torch.bfloat16, dev, 3)
        if w_gate.shape != w_in.shape:
            raise ValueError(f"{KERNEL}: w_gate {tuple(w_gate.shape)} != "
                             f"w_in {tuple(w_in.shape)}")
    if d_in != d or tuple(w_out.shape) != (E, f, d):
        raise ValueError(f"{KERNEL}: weights {tuple(w_in.shape)} / "
                         f"{tuple(w_out.shape)} do not fit d={d}")
    if d % 64 or f % 64:
        raise ValueError(f"{KERNEL}: d={d} and f={f} must be multiples of 64")
    if slot_w.shape != slot_to_token.shape:
        raise ValueError(f"{KERNEL}: slot_w and slot_to_token disagree")
    if rows_valid.shape[0] != len(exps) or max(exps) >= E or min(exps) < 0:
        raise ValueError(f"{KERNEL}: rows_valid / seg_experts do not fit "
                         f"{E} experts")
    tiles = _tiles_on(offs, exps, str(dev))
    n_tiles = tiles.shape[0]
    h = torch.empty((n_tiles * TILE_ROWS, f), dtype=torch.bfloat16,
                    device=dev)
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    fn = _entry()
    err = fn(backend.ptr(x), T, d, f, backend.ptr(slot_to_token),
             backend.ptr(slot_w), backend.ptr(rows_valid),
             backend.ptr(tiles), n_tiles, backend.ptr(w_in),
             backend.ptr(w_gate if swiglu else None), backend.ptr(w_out),
             backend.ptr(h), backend.ptr(out), int(swiglu),
             backend.stream_ptr(dev))
    backend.check(KERNEL, err)
    backend.record_launch(KERNEL)
    return out


def local_moe(x, slot_to_token, slot_w, seg_offsets, seg_experts, rows_valid,
              w_in, w_gate, w_out, *, activation: str = "swiglu",
              use_pallas=None):
    """Fused dispatch -> GEMM -> combine over local traffic.

    x: [T, d]; ``slot_to_token`` [S] / ``slot_w`` [S] are the flat
    sort-order maps (sentinel ``T`` marks empty slots, weight 0);
    ``seg_offsets`` (static [n + 1]) / ``seg_experts`` (static [n])
    describe the contiguous segments of slot space and ``rows_valid``
    (runtime [n] int32, or None = fully occupied) each segment's realized
    rows.  Returns the [T, d] float32 combined output.
    """
    offs = tuple(int(o) for o in seg_offsets)
    exps = tuple(int(e) for e in seg_experts)
    S = slot_to_token.shape[0]
    if not (len(offs) == len(exps) + 1 and offs[0] == 0 and offs[-1] == S):
        raise ValueError(f"bad segment layout {offs} for {len(exps)} "
                         f"segments and {S} slots")
    swiglu = activation == "swiglu" and w_gate is not None
    if rows_valid is None:
        rows_valid = torch.as_tensor(
            [offs[s + 1] - offs[s] for s in range(len(exps))],
            dtype=torch.int32, device=x.device)
    if S == 0:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if not backend.kernels_active(use_pallas, x.device):
        return local_moe_ref(x, slot_to_token, slot_w, offs, exps,
                             rows_valid, w_in, w_gate if swiglu else None,
                             w_out, activation=activation)
    return _local_moe_cuda(x, slot_to_token, slot_w, offs, exps, rows_valid,
                           w_in, w_gate, w_out, swiglu)
