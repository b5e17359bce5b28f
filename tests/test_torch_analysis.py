"""The port's static contract checkers (``repro_torch.analysis``) on the
CPU, against the JAX package's where they carry over.

* the collective inventory the Eq. (7) plan promises equals the
  reference's ``hlo_check.expected_inventory`` on its fifteen default
  scenarios, except the gather path, whose chain differs by design (one
  all-gather and one all-reduce over the EP axes' group, not one pair an
  axis), pinned here by name;
* every scenario's inventory recorded through the recording world
  matches its expectation (one process; no world is spawned);
* ``python -m repro_torch.analysis`` exits 0 on the tree and 1 on every
  planted fixture, and each fixture fires the rule it plants;
* the registered launch layouts of all eight kernels pass the launch
  check; the tile tables pass ``plan-tiles`` on the segment tables of
  the 2x2, 2x2x2 and pipelined plans and on random tables;
* the recording world's semantics, and the lint's rules on small
  sources.

Only the reference's pure-Python ``expected_inventory`` serves as an
oracle: its ``lower_scenario`` fails under this jax (see ROADMAP.md).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import hlo_check
from repro_torch.analysis import (__main__ as cli, collective_check, fixtures,
                                  launch_check, lint)
from repro_torch.kernels import backend, layouts
from repro_torch.kernels.moe_fused import ops as fused_ops
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.launch import mesh

#: scenarios whose chain differs from the reference's by design: the
#: gather path's one all-gather and one all-reduce over the EP axes' group
#: (``transport.GatherTransport``: a gloo collective costs about 13 ms on
#: a shared card, so the port pays it once, not once an axis)
GATHER_DIFFERS = ("gather-2x2-ref", "gather-2x2-kernels", "gather-2x2x2-ref")


def reference_scenario(sc):
    """The reference's scenario of the same name: the wire-bf16 case takes
    the deprecated ``a2a_dtype`` in both packages."""
    return hlo_check.Scenario(
        name=sc.name, axis_sizes=sc.axis_sizes, path=sc.path,
        use_pallas=sc.use_pallas, num_chunks=sc.num_chunks,
        a2a_dtype=sc.a2a_dtype, wire_codec=sc.wire_codec)


def test_expected_inventory_matches_reference():
    scenarios = collective_check.default_scenarios()
    assert [sc.name for sc in scenarios] == [
        sc.name for sc in hlo_check.default_scenarios()]
    for sc in scenarios:
        want = hlo_check.expected_inventory(reference_scenario(sc))
        got = collective_check.expected_inventory(sc)
        if sc.name not in GATHER_DIFFERS:
            assert [dataclasses.astuple(c) for c in got] == \
                [dataclasses.astuple(c) for c in want], sc.name
            continue
        # the reference: an all-gather and a psum an axis of size > 1
        live = [a for a, n in zip(sc.axis_names, sc.axis_sizes) if n > 1]
        assert [(c.kind, c.groups) for c in want] == [
            (kind, hlo_check.axis_groups(sc.axis_names, sc.axis_sizes, a))
            for a in live for kind in ("all_gather", "all_reduce")]
        # the port: one of each over the group of every EP axis, the
        # tokens in, their gathered partial outputs summed
        group = (tuple(range(int(np.prod(sc.axis_sizes)))),)
        ranks = int(np.prod(sc.axis_sizes))
        assert [dataclasses.astuple(c) for c in got] == [
            ("all_gather", "f32", sc.tokens * sc.d_model, group),
            ("all_reduce", "f32", ranks * sc.tokens * sc.d_model, group)]
    # the scaled codecs carry the reference's one f32 scale exchange of
    # num_dests x E_l elements per payload exchange
    int8 = next(sc for sc in scenarios if sc.wire_codec == "int8")
    got = collective_check.expected_inventory(int8)
    assert sum(c.dtype == "f32" for c in got) == \
        sum(c.dtype == "i8" for c in got) > 0


def test_recorded_inventories_match_expectations():
    for sc in collective_check.default_scenarios():
        assert collective_check.verify(sc) == [], sc.name
    # at other widths, chunk counts and codecs too
    for sc in (collective_check.Scenario("a2a_pipelined-2x2-int8-c4", (2, 2),
                                         "a2a_pipelined", True, num_chunks=4,
                                         wire_codec="int8", tokens=48,
                                         num_experts=8),
               collective_check.Scenario("gather-2x2x2-kernels", (2, 2, 2),
                                         "gather", True, tokens=8),
               collective_check.Scenario("a2a-2x2-wire-fp8", (2, 2), "a2a",
                                         False, wire_codec="fp8e4m3")):
        assert collective_check.verify(sc) == [], sc.name
    # axis_groups of several axes: the ranks that share the other axes
    assert collective_check.axis_groups(("pod", "node", "data"), (2, 2, 2),
                                        ("node", "data")) == (
        (0, 1, 2, 3), (4, 5, 6, 7))


def test_cli_exits_0_on_the_tree_and_1_on_every_fixture(tmp_path, capsys):
    path = tmp_path / "report.json"
    assert cli.main(["--json", str(path)]) == 0
    report = json.loads(path.read_text())
    assert report["ok"] and not report["violations"]
    assert set(report["checked"]) == {"collective", "launch", "lint"}
    assert cli.main(["--list-fixtures"]) == 0
    names = capsys.readouterr().out.split()
    assert sorted(names) == sorted(fixtures.FIXTURES) and len(names) == 8
    for name in names:
        assert cli.main(["--fixture", name, "--json",
                         str(tmp_path / f"{name}.json")]) == 1, name
    assert cli.main(["--only", "lint", "--json", str(path)]) == 0


def test_every_rule_fires_and_the_registry_passes():
    fired = {}
    for name, fn in fixtures.FIXTURES.items():
        fired[name] = {v.rule for v in fn()}
        assert set(fixtures.RULES[name]) <= fired[name], (name, fired[name])
    rules = {r for rs in fixtures.RULES.values() for r in rs}
    assert rules == {"collective-inventory", "smem-budget", "grid-bounds",
                     "index-bounds", "plan-tiles", "scatter-race",
                     "raw-collective", "foreign-import", "kernel-fallback",
                     "unchecked-launch"}
    # the split past the cache and the group past MAX_G, each flagged
    assert [v.message.split(":")[0] for v in fixtures.split_past_cache()
            ] == ["block 2 addresses rows 1024", "block 0 addresses rows 0"]
    # the tree
    violations, covered = launch_check.run()
    assert violations == []
    assert {lay.split("[")[0] for lay in covered} == set(backend.LAUNCHES)
    assert lint.run()[0] == []


def _segments(rng, n, experts, max_w):
    widths = rng.integers(0, max_w, size=n)
    offs = tuple(int(o) for o in np.concatenate([[0], np.cumsum(widths)]))
    exps = tuple(sorted(int(e) for e in rng.integers(0, experts, size=n)))
    return offs, exps


def test_tile_tables_pass_plan_tiles_on_the_plans():
    a = layouts.arch()
    d, f = a.d_model, a.moe.d_ff_expert
    tables = [(lay.seg_offsets, lay.seg_experts)
              for lay in (layouts.staged(), layouts.staged((2, 2, 2)),
                          layouts.staged(num_chunks=8))]
    assert [t[0][-1] for t in tables] == [4864, 3200, 608]
    rng = np.random.default_rng(0)
    tables += [_segments(rng, int(n), 6, 150)
               for n in rng.integers(1, 40, size=20)]
    for offs, exps in tables:
        if offs[-1] == 0:
            continue
        for lay in (gemm_ops.span_layout("k3", "t", offs, exps, d, f),
                    gemm_ops.span_layout("k7", "t", offs, exps, d, f,
                                         quant=True),
                    fused_ops.local_moe_layout("t", offs, exps, 64, d, f)):
            assert launch_check.check_layout(lay) == [], (lay.kernel, offs)


def test_recording_world_records_without_communicating():
    rw = mesh.recording_world((2, 2))
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    assert rw.all_to_all(x, "pod", 0) is x
    with pytest.raises(ValueError):
        rw.all_to_all(x, "data", 1)
    g = rw.all_gather(x[0], ("pod", "data"))
    assert torch.equal(g, x[0].repeat(4, 1))
    s = rw.all_reduce_sum(x, ("data",))
    assert torch.equal(s, x) and s is not x
    assert rw.all_reduce_sum(x, ()) is x          # no live axis: no call
    m = rw.all_to_all(torch.empty((2, 5), device="meta",
                                  dtype=torch.bfloat16), "data", 0)
    assert m.is_meta
    assert [(k, dt, n, ax) for k, dt, n, ax in rw.log] == [
        ("all_to_all", torch.float32, 24, ("pod",)),
        ("all_gather", torch.float32, 12, ("pod", "data")),
        ("all_reduce", torch.float32, 24, ("data",)),
        ("all_to_all", torch.bfloat16, 10, ("data",))]
    inv = collective_check.inventory(rw)
    assert inv[1] == collective_check.Collective(
        "all_gather", "f32", 12, ((0, 1, 2, 3),))
    assert inv[3].groups == ((0, 1), (2, 3)) and inv[3].dtype == "bf16"
    unit = mesh.recording_world((1,))
    assert unit.all_gather(x, "data") is x and unit.log == []
    assert mesh.make_production_mesh().axis_sizes == (16,)
    assert mesh.make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data")
    assert mesh.make_production_mesh_3tier().axis_sizes == (2, 2, 8)


LINT_CASES = {
    # rule -> (a source that breaks it, one that does not)
    "raw-collective": (
        "import torch.distributed as dist\ndist.all_reduce(t)\n",
        "import torch.distributed as dist\ndist.get_rank()\n"),
    "foreign-import": ("from repro.core import capacity\n",
                       "from repro_torch.core import capacity\n"),
    "kernel-fallback": (
        "import torch\nDEV = 'cuda' if torch.cuda.is_available() else 'cpu'\n",
        "import torch\nDEV = 'cuda'\n"),
    "unchecked-launch": (
        "from repro_torch.kernels import backend\n"
        "def _entry():\n    return backend.bind('a', 'b', [])\n"
        "def run(x):\n    err = _entry()(x)\n    return err\n",
        "from repro_torch.kernels import backend\n"
        "def _entry():\n    return backend.bind('a', 'b', [])\n"
        "def run(x):\n    fn = _entry()\n    err = fn(x)\n"
        "    backend.check('k', err)\n"),
}


def test_lint_rules_on_small_sources():
    for rule, (bad, good) in LINT_CASES.items():
        assert [v.rule for v in lint.lint_source(
            bad, "x.py", "repro_torch/x.py")] == [rule], rule
        assert lint.lint_source(good, "x.py", "repro_torch/x.py") == [], rule
    # collectives are mesh.py's own; an ops.py handler that re-raises is no
    # fallback, one that returns is
    src = LINT_CASES["raw-collective"][0]
    assert lint.lint_source(src, "m.py", "repro_torch/launch/mesh.py") == []
    ops = ("def f(x):\n    try:\n        return g(x)\n"
           "    except ValueError as e:\n        {}\n")
    path = "repro_torch/kernels/k/ops.py"
    assert lint.lint_source(ops.format("raise RuntimeError() from e"),
                            "ops.py", path) == []
    assert [v.rule for v in lint.lint_source(
        ops.format("return x"), "ops.py", path)] == ["kernel-fallback"]
    # the root scripts may pick a device by the card's presence
    assert lint.lint_source(LINT_CASES["kernel-fallback"][0], "chip_x.py",
                            "chip_x.py", in_package=False) == []
