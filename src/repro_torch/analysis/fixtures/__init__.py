"""Planted-violation fixtures: each proves a checker rule fires.

``python -m repro_torch.analysis --fixture NAME`` runs one of these and
exits 1 when the check reports the planted violation.  The fixtures live
in their own package, which the tree's lint skips: they exist to be
wrong.

* ``collective_mismatch`` — a real (2x2, kernels on) ``a2a`` recording
  against an expectation with the count chain dropped: the diff must
  flag the count exchanges as unexpected traffic;
* ``missing_scale_exchange`` — a real int8-wire (2x2, kernels on)
  recording against an expectation with the f32 scale sideband dropped;
* ``smem_over_budget`` — K5's launch at head dim 128 with a dynamic
  shared memory past the sm_90 opt-in limit (``smem-budget``);
* ``unguarded_scatter`` — K4's decode layout with its down launch adding
  its rows into ``out`` by token, as an atomic combine would, and no
  atomic accumulation declared (``scatter-race``);
* ``straddling_tile`` — K4's train_1rank tile table with a tile shifted
  across a segment boundary (``plan-tiles``);
* ``empty_grid`` — K3's launches at zero tiles, which its entry skips
  (``grid-bounds``);
* ``split_past_cache`` — K8's launches at a 1000-row cache with one
  split block too many and 32 query heads a KV head (``index-bounds``);
* ``raw_collective`` — ``raw_collective_fixture.pysrc``: a
  ``torch.distributed`` collective outside ``launch/mesh.py``, plus a
  specimen of every other lint rule.
"""

from __future__ import annotations

import dataclasses
import pathlib


def collective_mismatch():
    from repro_torch.analysis import collective_check

    sc = collective_check.Scenario("fixture-collective-mismatch", (2, 2),
                                   "a2a", True)
    tampered = [c for c in collective_check.expected_inventory(sc)
                if c.dtype != "i32"]
    return collective_check.verify(sc, expected=tampered)


def missing_scale_exchange():
    from repro_torch.analysis import collective_check

    sc = collective_check.Scenario("fixture-missing-scale-exchange", (2, 2),
                                   "a2a", True, wire_codec="int8")
    tampered = [c for c in collective_check.expected_inventory(sc)
                if c.dtype != "f32"]
    return collective_check.verify(sc, expected=tampered)


def smem_over_budget():
    from repro_torch.analysis import launch_check
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attn import ops

    launch = ops.flash_launch(4, 512, 16, 16, 128)
    # a [64 + 4 * 256, 128] bf16 stage set: 272 KB a block
    big = dataclasses.replace(launch, dyn_smem=(64 + 4 * 256) * 128 * 2)
    layout = backend.KernelLayout("fixture.smem_over_budget", (big,))
    violations, _ = launch_check.run(layouts=[layout])
    return violations


def _k4_layout(label):
    from repro_torch.kernels import layouts
    from repro_torch.kernels.moe_fused import ops

    a = layouts.arch()
    if label == "decode":
        offs, exps = layouts.gathered(8)
        T = 8
    else:
        T, offs, exps = layouts.local()
    return ops.local_moe_layout(f"fixture {label}", offs, exps, T,
                                a.d_model, a.moe.d_ff_expert)


def unguarded_scatter():
    from repro_torch.analysis import launch_check
    from repro_torch.kernels import backend

    layout = _k4_layout("decode")
    adding = backend.Write("out", lambda x, y, z: (0, 8, y))
    launches = tuple(
        dataclasses.replace(ln, writes=(adding,))
        if ln.kernel == "fused_down_kernel" else ln
        for ln in layout.launches)
    layout = dataclasses.replace(layout, kernel="fixture.unguarded_scatter",
                                 launches=launches)
    violations, _ = launch_check.run(layouts=[layout])
    return violations


def straddling_tile():
    from repro_torch.analysis import launch_check

    layout = _k4_layout("train_1rank")
    tiles = layout.meta["tiles"].copy()
    tiles[1, 0] += 32            # tile 1 now reaches 32 rows into segment 1
    layout = dataclasses.replace(layout, kernel="fixture.straddling_tile",
                                 meta={**layout.meta, "tiles": tiles})
    violations, _ = launch_check.run(layouts=[layout])
    return violations


def empty_grid():
    from repro_torch.analysis import launch_check
    from repro_torch.kernels import backend, layouts
    from repro_torch.kernels.moe_gemm import ops

    lay = layouts.staged()
    launches = tuple(dataclasses.replace(ln, grid=(0,) + ln.grid[1:],
                                         spans=())
                     for ln in ops.span_launches(lay.seg_offsets,
                                                 lay.seg_experts, lay.d,
                                                 lay.f))
    layout = backend.KernelLayout("fixture.empty_grid", launches)
    violations, _ = launch_check.run(layouts=[layout])
    return violations


def split_past_cache():
    from repro_torch.analysis import launch_check
    from repro_torch.kernels import backend
    from repro_torch.kernels.decode_attn import ops

    split, combine = ops.decode_launches(4, 1000, 16, 16, 64)
    x, _, z = split.grid
    bad = dataclasses.replace(split, grid=(x, 3, z), spans=(
        backend.Span("cache rows", 1000,
                     *backend.blocks(3, ops.SPLIT_ROWS, 1000)),
        backend.Span("query heads a kv head", ops.MAX_GROUP, (0,), (32,))))
    layout = backend.KernelLayout("fixture.split_past_cache", (bad, combine))
    violations, _ = launch_check.run(layouts=[layout])
    return violations


def raw_collective():
    from repro_torch.analysis import lint

    path = pathlib.Path(__file__).with_name("raw_collective_fixture.pysrc")
    return lint.lint_source(
        path.read_text(), str(path),
        "repro_torch/analysis/fixtures/raw_collective_fixture.pysrc")


FIXTURES = {
    "collective_mismatch": collective_mismatch,
    "missing_scale_exchange": missing_scale_exchange,
    "smem_over_budget": smem_over_budget,
    "unguarded_scatter": unguarded_scatter,
    "straddling_tile": straddling_tile,
    "empty_grid": empty_grid,
    "split_past_cache": split_past_cache,
    "raw_collective": raw_collective,
}

#: the rule each fixture plants
RULES = {
    "collective_mismatch": ("collective-inventory",),
    "missing_scale_exchange": ("collective-inventory",),
    "smem_over_budget": ("smem-budget",),
    "unguarded_scatter": ("scatter-race",),
    "straddling_tile": ("plan-tiles",),
    "empty_grid": ("grid-bounds",),
    "split_past_cache": ("index-bounds",),
    "raw_collective": ("raw-collective", "foreign-import", "kernel-fallback",
                       "unchecked-launch"),
}


def run_fixture(name: str):
    try:
        fn = FIXTURES[name]
    except KeyError:
        raise ValueError(f"unknown fixture {name!r}; "
                         f"available: {sorted(FIXTURES)}") from None
    return fn()
