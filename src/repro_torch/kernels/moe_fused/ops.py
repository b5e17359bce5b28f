"""Public fused local-MoE entry with the backend policy (the counterpart of
``repro/kernels/moe_fused/ops.py``).

:func:`local_moe` takes the raw [T, d] token buffer, the flat slot maps
(``slot_to_token`` / ``slot_w``), the static segment layout and its
runtime ``rows_valid`` occupancy, and returns the [T, d] float32 combined
output.  For CUDA tensors (with kernels wanted) it launches the
hand-written kernel of ``csrc/moe_fused.cu`` (a compaction of the slots
that carry a combine weight and the token index over them, the up and
down launches over those slots, and a combine that sums each token's
rows in slot order, so repeated calls give equal bits) inside a
``torch.autograd.Function`` whose backward is autograd through
:func:`ref.local_moe_ref` with the cotangent in float32, as the
reference's ``_fused_bwd`` is ``jax.vjp`` of it; for CPU tensors it runs
the plain version.  :func:`compact_slots` and :func:`token_rows` are the
compaction launch and the token index's launches on their own, for
holding them against :func:`ref.compact_slots` and :func:`ref.token_rows`
on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.kernels.moe_fused import ref

KERNEL = "moe_fused.local_moe"
TILE_ROWS = ref.TILE_ROWS   # BM of csrc/moe_fused.cu (checked at bind time)
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


def down_splits(seg_offsets: tuple, f: int) -> int:
    """Blocks the down launch splits each tile's f reduction over: 4 when
    no segment is wider than a tile (the decode layout: a few live rows in
    at most one tile an expert, too few blocks to fill the card otherwise),
    else 1; halved until 64 * splits divides f."""
    widest = max((b - a for a, b in zip(seg_offsets, seg_offsets[1:])),
                 default=0)
    splits = 4 if widest <= TILE_ROWS else 1
    while f % (64 * splits):
        splits //= 2
    return splits


@functools.lru_cache(maxsize=64)
def layout_on(seg_offsets: tuple, seg_experts: tuple, f: int, device: str):
    """K4's per-layout tables on ``device``, made once per layout, width
    and device: the segment offsets (int32 [n + 1]), :func:`plan_tiles`,
    each segment's first tile (int32 [n]) and :func:`down_splits`."""
    tiles = plan_tiles(seg_offsets, seg_experts)
    tile0 = np.searchsorted(tiles[:, 2], np.arange(len(seg_experts)))
    return (torch.as_tensor(seg_offsets, dtype=torch.int32, device=device),
            torch.as_tensor(tiles, device=device),
            torch.as_tensor(tile0, dtype=torch.int32, device=device),
            down_splits(seg_offsets, f))


@functools.lru_cache(maxsize=64)
def plan_expert_tiles(seg_offsets: tuple, seg_experts: tuple,
                      rows: int = TILE_ROWS) -> np.ndarray:
    """Expert-span tiling of a segment layout: int32 [n_tiles, 3] rows of
    (first row, expert, rows in the tile).  The consecutive non-empty
    segments of one expert form a span, cut into ``ceil(width / rows)``
    tiles with the last one row-masked: a tile may cross segment
    boundaries but never experts.  Zero-width segments and experts with
    no rows add no tile."""
    out, start, expert = [], None, None
    bounds = [(int(seg_offsets[s]), int(seg_offsets[s + 1]), int(e))
              for s, e in enumerate(seg_experts)
              if seg_offsets[s + 1] > seg_offsets[s]]
    for lo, hi, e in bounds + [(None, None, None)]:
        if start is not None and (e != expert or lo != end):
            for r in range(start, end, rows):
                out.append((r, expert, min(rows, end - r)))
            start = None
        if lo is not None:
            if start is None:
                start, expert = lo, e
            end = hi
    return np.asarray(out, np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=64)
def expert_tiles_on(seg_offsets: tuple, seg_experts: tuple, device: str):
    """:func:`plan_expert_tiles` and each segment's first row (int32 [S])
    on ``device``, made once per layout and device."""
    return (torch.as_tensor(plan_expert_tiles(seg_offsets, seg_experts),
                            device=device),
            torch.as_tensor(seg_offsets[:-1], dtype=torch.int32,
                            device=device))


@functools.lru_cache(maxsize=1)
def _entry():
    lib = backend.load("moe_fused")
    rows = lib.moe_fused_tile_rows
    rows.argtypes, rows.restype = [], ctypes.c_int
    if rows() != TILE_ROWS:
        raise RuntimeError(f"moe_fused.cu tiles {rows()} rows, the wrapper "
                           f"plans {TILE_ROWS}")
    return backend.bind("moe_fused", "local_moe_fused",
                        [_V, _I, _I, _I, _V, _V, _V, _V, _I, _V, _V, _I, _V,
                         _V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _V])


@functools.lru_cache(maxsize=1)
def _compact_entry():
    return backend.bind("moe_fused", "compact_slots",
                        [_V, _V, _V, _V, _I, _I, _V, _V, _V])


@functools.lru_cache(maxsize=1)
def _token_rows_entry():
    return backend.bind("moe_fused", "token_rows",
                        [_V, _V, _V, _V, _I, _V, _V, _I, _I, _V, _V, _V, _V,
                         _V])


def _index_scratch(S: int, n_seg: int, n_tiles: int, T: int, dev,
                   lead: int = 0):
    """One uint8 scratch of ``lead`` bytes, then the int32 live [S], count
    [n_seg], tile_nv [n_tiles] and the token index [2 T + 1 + 2 R], R =
    n_tiles * 64 (counts, row_ptr, the lists' rows and weights); returns
    it and the address of live."""
    ints = S + n_seg + n_tiles + 2 * T + 1 + 2 * n_tiles * TILE_ROWS
    scratch = torch.empty(lead + 4 * ints, dtype=torch.uint8, device=dev)
    return scratch, scratch.data_ptr() + lead


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


def _local_moe_cuda(static, x, slot_to_token, slot_w, rows_valid, w_in,
                    w_gate, w_out):
    offs, exps, activation = static
    swiglu = activation == "swiglu"
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
    if any(t.data_ptr() % 16 for t in (x, w_in, w_out, w_gate)
           if t is not None):
        raise ValueError(f"{KERNEL}: x and the weights must be 16-byte "
                         f"aligned")
    if slot_w.shape != slot_to_token.shape:
        raise ValueError(f"{KERNEL}: slot_w and slot_to_token disagree")
    if rows_valid.shape[0] != len(exps) or max(exps) >= E or min(exps) < 0:
        raise ValueError(f"{KERNEL}: rows_valid / seg_experts do not fit "
                         f"{E} experts")
    offs_dev, tiles, tile0, splits = layout_on(offs, exps, f, str(dev))
    n_seg, n_tiles, S = len(exps), tiles.shape[0], slot_to_token.shape[0]
    # one scratch allocation: h [n_tiles * 64, f] bf16, y [splits, n_tiles
    # * 64, d] f32 (only the live rows of either are written), then the
    # int32 live, count, tile_nv and token index
    h_bytes = n_tiles * TILE_ROWS * f * 2
    y_bytes = splits * n_tiles * TILE_ROWS * d * 4
    scratch, live = _index_scratch(S, n_seg, n_tiles, T, dev,
                                   h_bytes + y_bytes)
    index = live + 4 * (S + n_seg + n_tiles)
    out = torch.empty((T, d), dtype=torch.float32, device=dev)
    fn = _entry()
    err = fn(backend.ptr(x), T, d, f, backend.ptr(slot_to_token),
             backend.ptr(slot_w), backend.ptr(rows_valid),
             backend.ptr(offs_dev), n_seg, backend.ptr(tiles),
             backend.ptr(tile0), n_tiles, backend.ptr(w_in),
             backend.ptr(w_gate if swiglu else None), backend.ptr(w_out),
             live, live + 4 * S, live + 4 * (S + n_seg), scratch.data_ptr(),
             scratch.data_ptr() + h_bytes, index, backend.ptr(out),
             int(swiglu), splits, backend.stream_ptr(dev))
    backend.check(KERNEL, err)
    backend.record_launch(KERNEL)
    return out


def compact_slots(slot_to_token, slot_w, seg_offsets, rows_valid,
                  num_tokens: int, *, use_pallas=None):
    """The live slots of a segment layout (:func:`ref.compact_slots`):
    ``(live [S] int32, count [n] int32)``.  For CUDA tensors (with kernels
    wanted) the compaction launch of ``csrc/moe_fused.cu`` alone, which
    :func:`local_moe` runs first on every call; its launches are not
    counted (they are part of K4's, and this entry lies on no path).  CPU
    tensors take the plain version."""
    offs = tuple(int(o) for o in seg_offsets)
    dev = slot_to_token.device
    if not backend.kernels_active(use_pallas, dev):
        return ref.compact_slots(slot_to_token, slot_w, offs, rows_valid,
                                 num_tokens)
    S, n_seg = slot_to_token.shape[0], len(offs) - 1
    _check("slot_to_token", slot_to_token, torch.int32, dev, 1)
    _check("slot_w", slot_w, torch.float32, dev, 1)
    _check("rows_valid", rows_valid, torch.int32, dev, 1)
    if not (offs[0] == 0 and offs[-1] == S and slot_w.shape[0] == S
            and rows_valid.shape[0] == n_seg):
        raise ValueError(f"{KERNEL}: bad segment layout {offs} for {S} "
                         f"slots and {rows_valid.shape[0]} counts")
    live = torch.empty(S, dtype=torch.int32, device=dev)
    count = torch.empty(n_seg, dtype=torch.int32, device=dev)
    offs_dev = torch.as_tensor(offs, dtype=torch.int32, device=dev)
    err = _compact_entry()(backend.ptr(slot_to_token), backend.ptr(slot_w),
                           backend.ptr(rows_valid), backend.ptr(offs_dev),
                           n_seg, int(num_tokens), backend.ptr(live),
                           backend.ptr(count), backend.stream_ptr(dev))
    backend.check(KERNEL, err)
    return live, count


def token_rows(slot_to_token, slot_w, seg_offsets, seg_experts, rows_valid,
               num_tokens: int, *, use_pallas=None):
    """The token index of the combine (:func:`ref.token_rows`):
    ``(row_ptr [T + 1] int32, rows [n] int32)``, each token's live tile
    rows ascending.  For CUDA tensors (with kernels wanted) the launches of
    ``csrc/moe_fused.cu`` that :func:`local_moe` runs to build it (the
    compaction, the scan, the fill and the combine's sort) alone, on the
    tiles of :func:`plan_tiles`; not counted (they are part of K4's, and
    this entry lies on no path); it reads ``n`` back to the host.  CPU
    tensors take the plain version."""
    offs = tuple(int(o) for o in seg_offsets)
    exps = tuple(int(e) for e in seg_experts)
    dev = slot_to_token.device
    if not backend.kernels_active(use_pallas, dev):
        return ref.token_rows(slot_to_token, slot_w, offs, rows_valid,
                              num_tokens)
    S, n_seg, T = slot_to_token.shape[0], len(exps), int(num_tokens)
    _check("slot_to_token", slot_to_token, torch.int32, dev, 1)
    _check("slot_w", slot_w, torch.float32, dev, 1)
    _check("rows_valid", rows_valid, torch.int32, dev, 1)
    if not (len(offs) == n_seg + 1 and offs[0] == 0 and offs[-1] == S > 0
            and slot_w.shape[0] == S and rows_valid.shape[0] == n_seg
            and T > 0):
        raise ValueError(f"{KERNEL}: bad segment layout {offs} for {S} "
                         f"slots, {rows_valid.shape[0]} counts and {T} "
                         f"tokens")
    # the tables do not depend on f (64 only picks the cache entry)
    offs_dev, tiles, tile0, _ = layout_on(offs, exps, 64, str(dev))
    n_tiles = tiles.shape[0]
    scratch, live = _index_scratch(S, n_seg, n_tiles, T, dev)
    index = live + 4 * (S + n_seg + n_tiles)
    err = _token_rows_entry()(
        backend.ptr(slot_to_token), backend.ptr(slot_w),
        backend.ptr(rows_valid), backend.ptr(offs_dev), n_seg,
        backend.ptr(tiles), backend.ptr(tile0), n_tiles, T, live,
        live + 4 * S, live + 4 * (S + n_seg), index,
        backend.stream_ptr(dev))
    backend.check(KERNEL, err)
    ix = scratch[index - scratch.data_ptr():].view(torch.int32)
    row_ptr = ix[T:2 * T + 1].clone()
    n = int(row_ptr[-1])
    return row_ptr, ix[2 * T + 1:2 * T + 1 + n].clone()


#: the float32 expert weights one group of the backward casts at most
#: (``segment_groups``): autograd through ``local_moe_ref`` casts every
#: expert the segments name to float32 at once, which at Jamba's 16
#: experts of d 4096, f 14336 (11.3 GB, beside the bf16 copies and their
#: gradients) ran one rank's training step out of the card's memory
BACKWARD_GROUP_BYTES = 1 << 30


def segment_groups(seg_experts: tuple, expert_bytes: int,
                   budget: int = BACKWARD_GROUP_BYTES) -> list:
    """Contiguous ``(first, end)`` segment ranges, each naming experts
    whose float32 weights (``expert_bytes`` each) come to at most
    ``budget``, or one expert: the backward's groups.  A layout whose
    experts all fit is one group."""
    per = max(1, budget // max(expert_bytes, 1))
    groups, start, seen = [], 0, set()
    for s, e in enumerate(seg_experts):
        if e not in seen and len(seen) == per:
            groups.append((start, s))
            start, seen = s, set()
        seen.add(e)
    groups.append((start, len(seg_experts)))
    return groups


class LocalMoE(torch.autograd.Function):
    """``impl(static, x, slot_to_token, slot_w, rows_valid, w_in, w_gate,
    w_out)`` forward (the CUDA kernel, or the plain version when a test
    drives the backward on the CPU); backward: autograd through
    ``local_moe_ref`` with the cotangent in float32, over the segments
    of one ``segment_groups`` group at a time (each group's experts taken
    as leaves of their own, their gradients added into the whole
    tensors'; the input's gradient summed over the groups).  ``static``
    is ``(seg_offsets, seg_experts, activation)``."""

    @staticmethod
    def forward(ctx, x, slot_to_token, slot_w, rows_valid, w_in, w_gate,
                w_out, static, impl):
        ctx.static = static
        ctx.save_for_backward(x, slot_to_token, slot_w, rows_valid, w_in,
                              w_gate, w_out)
        return impl(static, x, slot_to_token, slot_w, rows_valid, w_in,
                    w_gate, w_out)

    @staticmethod
    def backward(ctx, g):
        offs, exps, activation = ctx.static
        x, tok, slot_w, rows_valid, w_in, w_gate, w_out = ctx.saved_tensors
        needs = ctx.needs_input_grad
        wg_in = w_gate if activation == "swiglu" else None
        weights = (w_in, wg_in, w_out)
        want_w = (needs[4], needs[5] and wg_in is not None, needs[6])
        mats = sum(w is not None for w in weights)
        groups = segment_groups(exps, 4 * mats * w_in.shape[1]
                                * w_in.shape[2])
        gx, gw = None, [None] * 3
        gsw = torch.zeros_like(slot_w) if needs[2] else None
        g32 = g.to(torch.float32)
        for first, end in groups:
            a, b = offs[first], offs[end]
            uniq = sorted(set(exps[first:end]))
            pos = {e: i for i, e in enumerate(uniq)}
            idx = torch.as_tensor(uniq, dtype=torch.int64, device=x.device)
            xi = x.detach().requires_grad_(needs[0])
            swi = slot_w[a:b].detach().requires_grad_(needs[2])
            ws = [None if w is None else
                  w.index_select(0, idx).detach().requires_grad_(want)
                  for w, want in zip(weights, want_w)]
            leaves = [xi, swi] + ws
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            if not wanted:
                break
            with torch.enable_grad():
                y = ref.local_moe_ref(
                    xi, tok[a:b], swi, tuple(o - a for o in
                                             offs[first:end + 1]),
                    tuple(pos[e] for e in exps[first:end]),
                    rows_valid[first:end], ws[0], ws[1], ws[2],
                    activation=activation)
                grads = iter(torch.autograd.grad(y, wanted, g32))
            got = [next(grads) if t is not None and t.requires_grad
                   else None for t in leaves]
            del y
            if got[0] is not None:
                # summed in float32 over the groups
                part = got[0].to(torch.float32)
                gx = part if gx is None else gx.add_(part)
            if got[1] is not None:
                gsw[a:b] = got[1]
            for i, part in enumerate(got[2:]):
                if part is not None:
                    if gw[i] is None:
                        gw[i] = torch.zeros_like(weights[i])
                    gw[i].index_add_(0, idx, part)
        if gx is not None:
            gx = gx.to(x.dtype)
        return gx, None, gsw, None, gw[0], gw[1], gw[2], None, None


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
        return ref.local_moe_ref(x, slot_to_token, slot_w, offs, exps,
                             rows_valid, w_in, w_gate if swiglu else None,
                             w_out, activation=activation)
    static = (offs, exps, "swiglu" if swiglu else "gelu")
    return LocalMoE.apply(x, slot_to_token, slot_w, rows_valid, w_in,
                          w_gate if swiglu else None, w_out, static,
                          _local_moe_cuda)


# ---------------------------------------------------------------------------
# launch layouts (backend.register_kernel; csrc/moe_fused.cu's geometry)
# ---------------------------------------------------------------------------

#: csrc/moe_fused.cu and moe_mma.cuh: block sizes (each the kernel's launch
#: bound), 8 KB stage tiles in rings of 3, and each launch's static
#: __shared__ arrays (compaction: warp_n[8]; scan: warp_sum[32]; up and
#: down: a_row[64]; the fill and the combine none)
THREADS, COMPACT_THREADS, SCAN_THREADS, COMBINE_THREADS = 128, 256, 1024, 256
STAGE_TILE = 64 * 64 * 2
UP_SMEM, UP_SMEM_SWIGLU, DOWN_SMEM = (3 * 2 * STAGE_TILE, 3 * 3 * STAGE_TILE,
                                      3 * 2 * STAGE_TILE)
COMPACT_STATIC, SCAN_STATIC, UP_STATIC, DOWN_STATIC = (
    backend.static_smem(n) for n in (4 * 8, 4 * 32, 4 * 64, 4 * 64))


def local_moe_launches(seg_offsets: tuple, seg_experts: tuple, T: int,
                       d: int, f: int, swiglu: bool = False) -> tuple:
    """K4's six launches for one call, in their order: the compaction over
    segments, the scan (one block), the fill over tiles, the up launch
    over (tile, f / 64), the down launch over (tile, d / 64, splits) and
    the combine over tokens, from the wrapper's own :func:`plan_tiles` and
    :func:`down_splits`.  No two blocks of a launch write one element:
    the down launch stores each split of a tile's rows in its own place,
    the combine a row of ``out`` a block.  The fill's writes, at places
    in each token's list claimed by integer atomics, are distinct by
    construction and not declared."""
    tiles = plan_tiles(seg_offsets, seg_experts)
    splits = down_splits(seg_offsets, f)
    n_seg, n_tiles = len(seg_experts), tiles.shape[0]
    S, E, R = seg_offsets[-1], max(seg_experts) + 1, n_tiles * TILE_ROWS
    slots = backend.Span("slots", S, tuple(int(r) for r in tiles[:, 0]),
                         tuple(int(r) for r in tiles[:, 4]))
    experts = backend.Span("experts", E, tuple(int(e) for e in tiles[:, 1]),
                           (1,) * n_tiles)
    h_rows = backend.Span("h", R, *backend.blocks(n_tiles, TILE_ROWS, R))
    tokens = backend.Span("tokens", T, tuple(range(T)), (1,) * T)
    compact = backend.LaunchDecl(
        "compact_kernel", (n_seg, 1, 1), COMPACT_THREADS, 0, COMPACT_STATIC,
        COMPACT_THREADS,
        spans=(backend.Span("segments", n_seg, tuple(range(n_seg)),
                            (1,) * n_seg),),
        writes=(backend.Write("live", lambda x, y, z: (
            seg_offsets[x], seg_offsets[x + 1], 0)),))
    scan = backend.LaunchDecl(
        "scan_kernel", (1, 1, 1), SCAN_THREADS, 0, SCAN_STATIC, SCAN_THREADS,
        spans=(backend.Span("row_ptr", T + 1, (0,), (T + 1,)),),
        writes=(backend.Write("row_ptr", lambda x, y, z: (0, T + 1, 0)),))
    fill = backend.LaunchDecl(
        "fill_kernel", (n_tiles, 1, 1), TILE_ROWS, 0, 0, TILE_ROWS,
        spans=(slots,))
    up = backend.LaunchDecl(
        f"fused_up_kernel<{str(swiglu).lower()}>", (n_tiles, f // 64, 1),
        THREADS, UP_SMEM_SWIGLU if swiglu else UP_SMEM, UP_STATIC, THREADS,
        spans=(slots, experts, h_rows),
        writes=(backend.Write("h", lambda x, y, z: (
            x * TILE_ROWS, (x + 1) * TILE_ROWS, y)),))
    down = backend.LaunchDecl(
        "fused_down_kernel", (n_tiles, d // 64, splits), THREADS, DOWN_SMEM,
        DOWN_STATIC, THREADS, spans=(experts, h_rows),
        writes=(backend.Write("y", lambda x, y, z: (
            x * TILE_ROWS, (x + 1) * TILE_ROWS, (y, z))),))
    combine = backend.LaunchDecl(
        "combine_kernel", (T, 1, 1), COMBINE_THREADS, 0, 0, COMBINE_THREADS,
        spans=(tokens,),
        writes=(backend.Write("out", lambda x, y, z: (x, x + 1, 0)),))
    return compact, scan, fill, up, down, combine


def local_moe_layout(label: str, seg_offsets: tuple, seg_experts: tuple,
                     T: int, d: int, f: int,
                     swiglu: bool = False) -> backend.KernelLayout:
    tiles = plan_tiles(seg_offsets, seg_experts)
    return backend.KernelLayout(
        f"{KERNEL}[{label}]",
        local_moe_launches(seg_offsets, seg_experts, T, d, f, swiglu),
        meta={"seg_offsets": seg_offsets, "seg_experts": seg_experts,
              "tiles": tiles, "tile_kind": "segment",
              "geometry": ("moe_fused", "local_moe_fused_geometry",
                           (len(seg_experts), tiles.shape[0], T, d, f,
                            int(swiglu), down_splits(seg_offsets, f)))})


@backend.register_kernel(KERNEL)
def _local_moe_layouts():
    from repro_torch.kernels import layouts
    a = layouts.arch()
    d, f = a.d_model, a.moe.d_ff_expert
    out = []
    T, offs, exps = layouts.local()
    out.append(local_moe_layout(f"train_1rank S={offs[-1]}", offs, exps, T,
                                d, f))
    for ep_world in (1, 4):
        for Tg in (8, 512):
            offs, exps = layouts.gathered(Tg, ep_world)
            out.append(local_moe_layout(
                f"gather Tg={Tg} E_l={len(exps)}", offs, exps, Tg, d, f))
    offs, exps = layouts.gathered(8)
    out.append(local_moe_layout("gather Tg=8 swiglu", offs, exps, 8, d, f,
                                swiglu=True))
    # a model rank's f / TP_MODEL columns on a tensor-parallel world
    f_tp = f // layouts.TP_MODEL
    T, offs, exps = layouts.local()
    out.append(local_moe_layout(f"train_1rank S={offs[-1]} f={f_tp}", offs,
                                exps, T, d, f_tp))
    for Tg in (8, 512):
        offs, exps = layouts.gathered(Tg)
        out.append(local_moe_layout(
            f"gather Tg={Tg} E_l={len(exps)} f={f_tp}", offs, exps, Tg, d,
            f_tp))
    # the families' experts at a model rank's width through the gather
    # path of serve_tp2_families: DeepSeek-V2-Lite's (swiglu, f 704) at
    # its decode and prefill rows, Jamba's (swiglu, f 7168) at its decode
    # rows (its scan prefill steps have the same)
    for aid, Tgs in (("deepseek_v2_lite_16b", (4, 128)),
                     ("jamba_v0_1_52b", (4,))):
        fa = layouts.arch(aid)
        fd, ff = fa.d_model, fa.moe.d_ff_expert // layouts.TP_MODEL
        for Tg in Tgs:
            offs, exps = layouts.gathered(Tg, arch_id=aid)
            out.append(local_moe_layout(
                f"{aid} gather Tg={Tg} E_l={len(exps)} f={ff} swiglu", offs,
                exps, Tg, fd, ff, swiglu=True))
    # the families on the 2x2 EP world's gather path (serve_dsv2_2x2,
    # serve_dsv2_236b_2x2, serve_jamba_2x2): 8 decode slots, a prefill
    # pack of 4 x 128 (DeepSeek-V2-Lite and -236B) or a scan step of 4
    # rows (Jamba)
    for aid, Tgs in ((layouts.DSV2_ID, (8, 512)),
                     (layouts.DSV2_236B_ID, (8, 512)),
                     (layouts.JAMBA_ID, (8, 4))):
        fa = layouts.arch(aid)
        for Tg in Tgs:
            offs, exps = layouts.gathered(Tg, 4, arch_id=aid)
            out.append(local_moe_layout(
                f"{aid} 2x2 gather Tg={Tg} E_l={len(exps)} swiglu", offs,
                exps, Tg, fa.d_model, fa.moe.d_ff_expert, swiglu=True))
    # Jamba's one-rank training step (train_jamba_d2)
    fa = layouts.arch(layouts.JAMBA_ID)
    T, offs, exps = layouts.local(arch_id=layouts.JAMBA_ID)
    out.append(local_moe_layout(
        f"{layouts.JAMBA_ID} train_1rank S={offs[-1]} swiglu", offs, exps, T,
        fa.d_model, fa.moe.d_ff_expert, swiglu=True))
    return out
