"""Static launch-geometry checker of the CUDA kernels (the counterpart of
``repro/analysis/pallas_check.py``).

Walks the kernel registry (``kernels.backend.KERNEL_REGISTRY``: each
``kernels/<name>/ops.py`` states its launches at the shapes its paths run,
built by the functions its wrapper calls) and checks every
``LaunchDecl`` of every ``KernelLayout`` without a card:

* **smem-budget** — static plus dynamic shared memory of a block fits the
  sm_90 opt-in limit; the threads of a block are at most 1024 and equal
  the kernel's ``__launch_bounds__``;
* **grid-bounds** — grid x at most 2^31 - 1, y and z at most 65535, and no
  empty dimension: an entry skips a launch with no work, it does not
  make one;
* **index-bounds** — every block addresses rows inside its array (each
  ``Span``): slots, tiles, query blocks, cache splits, experts; K8's query
  heads a KV head stay within its group limit;
* **plan-tiles** — a layout's tile table against its segment table:
  K4's segment tiles (``tile_kind="segment"``) never straddle a segment,
  K3's and K7's expert-span tiles never cross an expert; both cover every
  row of every non-empty segment exactly once in tiles of at most
  ``TILE_ROWS`` rows, each tile multiplying its segment's expert;
* **scatter-race** — two blocks of one launch whose ``Write`` regions
  overlap must accumulate with atomics: the layout's
  ``meta["acc_guarded"]`` names the ``(launch, array)`` pair.

The limits are the sm_90 column of the CUDA C++ Programming Guide's
"Technical Specifications per Compute Capability" table; on the card,
``chip_smoke.py``'s ``analysis`` phase holds them against the device's
properties and every declaration against the geometry entry of its
source.
"""

from __future__ import annotations

import itertools

from repro_torch.analysis import Violation

# sm_90 limits (CUDA C++ Programming Guide, technical specifications per
# compute capability 9.0)
SM90_MAX_SMEM_PER_BLOCK = 227 * 1024      # opt-in, static + dynamic
SM90_MAX_THREADS_PER_BLOCK = 1024
SM90_MAX_GRID_X = 2 ** 31 - 1
SM90_MAX_GRID_YZ = 65535
SM90_MAX_THREADS_PER_SM = 2048
SM90_REGS_PER_SM = 64 * 1024
SM90_SMEM_PER_SM = 228 * 1024


def _v(rule, where, message):
    return Violation("launch", rule, where, message)


def check_smem(layout) -> list[Violation]:
    out = []
    for ln in layout.launches:
        where = f"{layout.kernel}:{ln.kernel}"
        total = ln.static_smem + ln.dyn_smem
        if total > SM90_MAX_SMEM_PER_BLOCK:
            out.append(_v("smem-budget", where,
                          f"{ln.static_smem} B static + {ln.dyn_smem} B "
                          f"dynamic shared memory a block exceeds the sm_90 "
                          f"opt-in limit of {SM90_MAX_SMEM_PER_BLOCK} B"))
        if not 1 <= ln.threads <= SM90_MAX_THREADS_PER_BLOCK:
            out.append(_v("smem-budget", where,
                          f"{ln.threads} threads a block (sm_90 allows 1 to "
                          f"{SM90_MAX_THREADS_PER_BLOCK})"))
        if ln.threads != ln.launch_bounds:
            out.append(_v("smem-budget", where,
                          f"{ln.threads} threads a block against "
                          f"__launch_bounds__({ln.launch_bounds})"))
    return out


def check_grid(layout) -> list[Violation]:
    out = []
    for ln in layout.launches:
        where = f"{layout.kernel}:{ln.kernel}"
        x, y, z = ln.grid
        if min(x, y, z) < 1:
            out.append(_v("grid-bounds", where,
                          f"grid {ln.grid} is empty: the entry must skip a "
                          f"launch with no work"))
        if x > SM90_MAX_GRID_X or y > SM90_MAX_GRID_YZ \
                or z > SM90_MAX_GRID_YZ:
            out.append(_v("grid-bounds", where,
                          f"grid {ln.grid} exceeds sm_90's ({SM90_MAX_GRID_X}"
                          f", {SM90_MAX_GRID_YZ}, {SM90_MAX_GRID_YZ})"))
    return out


def check_index_bounds(layout) -> list[Violation]:
    out = []
    for ln in layout.launches:
        for sp in ln.spans:
            where = f"{layout.kernel}:{ln.kernel}:{sp.array}"
            if len(sp.first) != len(sp.rows):
                out.append(_v("index-bounds", where,
                              f"{len(sp.first)} first rows for "
                              f"{len(sp.rows)} row counts"))
                continue
            for i, (f, n) in enumerate(zip(sp.first, sp.rows)):
                if n < 1 or f < 0 or f + n > sp.extent:
                    out.append(_v("index-bounds", where,
                                  f"block {i} addresses rows {f}:{f + n} of "
                                  f"an array of {sp.extent}"))
                    break
    return out


def check_plan_tiles(layout) -> list[Violation]:
    from repro_torch.kernels.moe_fused.ops import TILE_ROWS
    meta = layout.meta
    if "tiles" not in meta:
        return []
    offs = [int(o) for o in meta["seg_offsets"]]
    exps = [int(e) for e in meta["seg_experts"]]
    tiles = meta["tiles"]
    span_kind = meta["tile_kind"] == "expert_span"
    where = layout.kernel
    out = []
    seg_of = {}
    for s in range(len(exps)):
        for r in range(offs[s], offs[s + 1]):
            seg_of[r] = s
    covered = [0] * offs[-1]
    for b, t in enumerate(tiles):
        first = int(t[0])
        expert = int(t[1])
        rows = int(t[2] if span_kind else t[4])
        if not 1 <= rows <= TILE_ROWS or first < 0 \
                or first + rows > offs[-1]:
            out.append(_v("plan-tiles", where,
                          f"tile {b} covers rows {first}:{first + rows} "
                          f"(at most {TILE_ROWS} rows of {offs[-1]})"))
            continue
        segs = {seg_of[r] for r in range(first, first + rows)}
        if span_kind:
            bad = sorted({exps[s] for s in segs} - {expert})
            if bad:
                out.append(_v("plan-tiles", where,
                              f"tile {b} (rows {first}:{first + rows}) of "
                              f"expert {expert} crosses into expert(s) "
                              f"{bad}"))
        else:
            seg = int(t[2])
            if segs != {seg} or first - offs[seg] != int(t[3]):
                out.append(_v("plan-tiles", where,
                              f"tile {b} (rows {first}:{first + rows}) "
                              f"straddles segments {sorted(segs)}, declared "
                              f"segment {seg} at offset {int(t[3])}"))
            elif expert != exps[seg]:
                out.append(_v("plan-tiles", where,
                              f"tile {b} multiplies expert {expert} but lies "
                              f"in segment {seg} of expert {exps[seg]}"))
        for r in range(first, first + rows):
            covered[r] += 1
    bad = [r for r, c in enumerate(covered) if c != 1]
    if bad:
        r = bad[0]
        out.append(_v("plan-tiles", where,
                      f"{len(bad)} row(s) of non-empty segments covered "
                      f"other than once, first row {r} ({covered[r]} "
                      f"times)"))
    return out


def _blocks(grid):
    return itertools.product(*(range(n) for n in grid))


def check_scatter_race(layout) -> list[Violation]:
    guarded = set(layout.meta.get("acc_guarded", ()))
    out = []
    for ln in layout.launches:
        for w in ln.writes:
            if (ln.kernel, w.array) in guarded:
                continue
            by_key = {}
            for blk in _blocks(ln.grid):
                lo, hi, key = w.region(*blk)
                by_key.setdefault(key, []).append((lo, hi, blk))
            hit = None
            for key, spans in by_key.items():
                spans.sort()
                for a, b in zip(spans, spans[1:]):
                    if b[0] < a[1]:
                        hit = (a, b)
                        break
                if hit:
                    break
            if hit:
                (lo0, hi0, b0), (lo1, hi1, b1) = hit
                out.append(_v("scatter-race",
                              f"{layout.kernel}:{ln.kernel}:{w.array}",
                              f"blocks {b0} and {b1} both write rows "
                              f"{max(lo0, lo1)}:{min(hi0, hi1)} without a "
                              f"declared atomic accumulation (acc_guarded)"))
    return out


def check_layout(layout) -> list[Violation]:
    return (check_smem(layout) + check_grid(layout)
            + check_index_bounds(layout) + check_plan_tiles(layout)
            + check_scatter_race(layout))


def registered() -> list:
    """Every layout of the registry (importing the kernel packages
    registers them)."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.decode_attn import ops as _d     # noqa: F401
    from repro_torch.kernels.flash_attn import ops as _fa     # noqa: F401
    from repro_torch.kernels.moe_fused import ops as _f       # noqa: F401
    from repro_torch.kernels.moe_gemm import ops as _g        # noqa: F401
    from repro_torch.kernels.moe_permute import ops as _p     # noqa: F401
    return [lay for lays in backend.registered_layouts().values()
            for lay in lays]


def run(layouts=None) -> tuple[list[Violation], list[str]]:
    """Check every registered layout (or an explicit list, for fixtures).
    Returns ``(violations, covered_layout_names)``."""
    if layouts is None:
        layouts = registered()
    violations, covered = [], []
    for lay in layouts:
        covered.append(lay.kernel)
        violations.extend(check_layout(lay))
    return violations, covered


# ---------------------------------------------------------------------------
# on the card: the declarations against the geometry entries
# ---------------------------------------------------------------------------

#: ints a launch reports (csrc/launch_geom.cuh) and their order
GEOM_FIELDS = ("grid_x", "grid_y", "grid_z", "threads", "dyn_smem",
               "static_smem", "registers", "max_threads", "max_dyn_smem",
               "local_bytes", "blocks_per_sm")
LIMIT_FIELDS = ("max_threads_per_block", "max_grid_x", "max_grid_y",
                "max_grid_z", "smem_per_block_optin", "smem_per_sm",
                "regs_per_sm", "max_threads_per_sm", "regs_per_block")


def device_limits() -> dict:
    """The current device's limits, by ``cudaDeviceGetAttribute``
    (``launch_geom_device_limits`` of ``csrc/moe_permute.cu``)."""
    import ctypes

    from repro_torch.kernels import backend
    fn = backend.bind("moe_permute", "launch_geom_device_limits",
                      [ctypes.c_void_p])
    buf = (ctypes.c_int * len(LIMIT_FIELDS))()
    backend.check("launch_geom_device_limits", fn(ctypes.addressof(buf)))
    return dict(zip(LIMIT_FIELDS, buf))


def device_geometry(layout) -> list[dict]:
    """The launches the layout's source reports for its shapes
    (``meta["geometry"]``: library, entry, arguments), one dict of
    :data:`GEOM_FIELDS` a launch."""
    import ctypes

    from repro_torch.kernels import backend
    lib, entry, args = layout.meta["geometry"]
    fn = backend.bind(lib, entry, [ctypes.c_int] * len(args)
                      + [ctypes.c_void_p])
    n = len(layout.launches)
    k = len(GEOM_FIELDS)
    buf = (ctypes.c_int * (k * n))()
    backend.check(f"{layout.kernel} geometry",
                  fn(*args, ctypes.addressof(buf)))
    return [dict(zip(GEOM_FIELDS, buf[i * k:(i + 1) * k])) for i in range(n)]


def check_limits(limits: dict, props) -> list[Violation]:
    """The sm_90 constants against the device's limits and, where torch
    exposes them, ``torch.cuda.get_device_properties``."""
    want = {"smem_per_block_optin": SM90_MAX_SMEM_PER_BLOCK,
            "max_threads_per_block": SM90_MAX_THREADS_PER_BLOCK,
            "max_grid_x": SM90_MAX_GRID_X, "max_grid_y": SM90_MAX_GRID_YZ,
            "max_grid_z": SM90_MAX_GRID_YZ,
            "max_threads_per_sm": SM90_MAX_THREADS_PER_SM,
            "regs_per_sm": SM90_REGS_PER_SM, "smem_per_sm": SM90_SMEM_PER_SM}
    torch_names = {"smem_per_block_optin": "shared_memory_per_block_optin",
                   "max_threads_per_sm": "max_threads_per_multi_processor",
                   "regs_per_sm": "regs_per_multiprocessor",
                   "smem_per_sm": "shared_memory_per_multiprocessor"}
    out = []
    for key, value in want.items():
        got = {"cudaDeviceGetAttribute": limits[key]}
        if key in torch_names and hasattr(props, torch_names[key]):
            got["get_device_properties"] = getattr(props, torch_names[key])
        for src, v in got.items():
            if v != value:
                out.append(_v("device-limits", key,
                              f"sm_90 constant {value} but {src} gives {v}"))
    return out


def check_on_device(layouts=None) -> tuple[list[Violation], dict]:
    """On the card: every layout's declared launches equal its source's
    geometry entry (grid, threads, dynamic and static shared memory);
    each launch's threads equal the kernel's ``maxThreadsPerBlock``, its
    dynamic shared memory fits the opted-in maximum, registers x threads
    fit an SM and at least one block is resident an SM; and the sm_90
    constants equal the device's.  Returns ``(violations, readings)``,
    the readings by launch: registers, blocks an SM, shared memory,
    spills."""
    import torch
    if layouts is None:
        layouts = registered()
    limits = device_limits()
    violations = check_limits(limits, torch.cuda.get_device_properties(0))
    readings = {}
    for lay in layouts:
        for decl, got in zip(lay.launches, device_geometry(lay)):
            where = f"{lay.kernel}:{decl.kernel}"
            want = {"grid_x": decl.grid[0], "grid_y": decl.grid[1],
                    "grid_z": decl.grid[2], "threads": decl.threads,
                    "dyn_smem": decl.dyn_smem,
                    "static_smem": decl.static_smem,
                    "max_threads": decl.launch_bounds}
            for key, v in want.items():
                if got[key] != v:
                    violations.append(_v(
                        "device-geometry", where,
                        f"{key}: declared {v}, the entry reports "
                        f"{got[key]}"))
            if got["dyn_smem"] > got["max_dyn_smem"]:
                violations.append(_v(
                    "device-geometry", where,
                    f"{got['dyn_smem']} B dynamic shared memory over the "
                    f"kernel's opted-in {got['max_dyn_smem']} B"))
            if got["registers"] * got["threads"] > limits["regs_per_sm"]:
                violations.append(_v(
                    "device-geometry", where,
                    f"{got['registers']} registers x {got['threads']} "
                    f"threads exceed an SM's {limits['regs_per_sm']}"))
            if got["blocks_per_sm"] < 1:
                violations.append(_v("device-geometry", where,
                                     "no block fits an SM (occupancy 0)"))
            readings.setdefault(decl.kernel, {
                k: got[k] for k in ("registers", "blocks_per_sm",
                                    "static_smem", "dyn_smem",
                                    "local_bytes", "threads")})
    return violations, readings
