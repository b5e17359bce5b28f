"""Collective inventory checker (the counterpart of
``repro/analysis/hlo_check.py``).

The port has no program to lower: :func:`record_scenario` runs one
forward of the MoE engine for a dispatch path x topology through a
recording EP world (``launch.mesh.RecordingWorld``: alone it emulates
rank 0 of the world in one process, around a real rank's world it passes
every call through) and lists the collectives it was asked for.  The
inventory is held against what the Eq. (7) ``DispatchPlan`` promises:

* one all-to-all **chain** per active remote stage — stage ``s`` hops
  over its ``s + 1`` delivery axes (a hop over an axis of size 1 is
  none), each hop's rank groups exactly that axis's groups;
* per-hop payloads of ``num_dests x E_l x cap_chunk x d`` elements in
  the **wire dtype** (the resolved ``MoEConfig.wire_codec``), dispatch
  and combine, once a chunk on the pipelined path;
* the int32 valid-count exchange on the same chain exactly when the
  ragged branch is taken (``moe_gemm.ops.use_ragged``);
* for **scaled** codecs (int8 / fp8e4m3) the f32 scale sideband, one
  exchange of ``num_dests x E_l`` elements per payload exchange (the port
  moves the scales through the counts' chain: ``transport.py``);
* **no** other collective: the fused one-rank path makes none, the
  einsum baseline none;
* the gather path's **one** all-gather of the tokens and **one**
  all-reduce of the partial outputs over the group of every EP axis.
  The reference gathers and sums one axis at a time
  (``repro/analysis/hlo_check.py:174-181``); the port makes one of each
  over the EP axes' group, by design: a gloo collective costs about
  13 ms on a shared card, so it is paid once (``transport.py``).

The expected inventory is computed from the modules the engine uses
(``transport.plan_stages``, ``moe_fused.ops.use_fused``,
``moe_gemm.ops.use_ragged``, the codec), so a plan change moves both
sides while a mapping fault moves only the recording.  Dtype names are
the reference's StableHLO ones (``f32``, ``i32``, ``bf16``, ``i8``,
``f8E4M3FN``).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.analysis import Violation

# innermost axis last, matching EPSpec's outermost-first hierarchy order
_AXIS_NAMES = {1: ("data",), 2: ("pod", "data"), 3: ("pod", "node", "data")}

# dtype name (torch's, which are the reference's jnp names) -> StableHLO
# element type
_HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
              "int32": "i32", "int8": "i8", "float8_e4m3fn": "f8E4M3FN",
              "float8_e5m2": "f8E5M2", "int64": "i64", "uint8": "ui8"}
HLO_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "i32": 4, "i8": 1,
              "f8E4M3FN": 1, "f8E5M2": 1, "i64": 8, "ui8": 1}


def hlo_dtype(dtype) -> str:
    """StableHLO name of a torch dtype or a dtype name."""
    name = dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]
    return _HLO_DTYPE[name]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One recording under verification: dispatch path x topology x kernel
    flag (x wire codec / chunk count), at the given widths."""

    name: str
    axis_sizes: tuple
    path: str
    use_pallas: bool | None
    num_chunks: int = 1
    a2a_dtype: str = ""           # deprecated cast-only wire (kept for the
                                  # alias coverage); prefer wire_codec
    wire_codec: str = ""          # registered codec name in dispatch.wire
    tokens: int = 32
    num_experts: int = 16
    d_model: int = 16
    d_ff: int = 32
    top_k: int = 2
    capacity_factor: float = 2.0
    dtype: str = "float32"
    activation: str = "gelu"

    @property
    def axis_names(self) -> tuple:
        return _AXIS_NAMES[len(self.axis_sizes)]


def default_scenarios() -> tuple:
    """All four dispatch paths on the 2-level (2x2) and 3-level (2x2x2)
    worlds, kernels on and off, plus the pipelined chunking, the fused
    one-rank zero-collective pin, a cast wire (the deprecated
    ``a2a_dtype="bfloat16"``, as the reference's takes it), and the scaled
    (int8 / fp8e4m3) wire codecs with their scale sidebands: the
    reference's fifteen."""
    return (
        Scenario("a2a-2x2-ref", (2, 2), "a2a", False),
        Scenario("a2a-2x2-kernels", (2, 2), "a2a", True),
        Scenario("a2a_pipelined-2x2-kernels", (2, 2), "a2a_pipelined", True,
                 num_chunks=2),
        Scenario("gather-2x2-ref", (2, 2), "gather", False),
        Scenario("gather-2x2-kernels", (2, 2), "gather", True),
        Scenario("einsum-2x2", (2, 2), "einsum", False),
        Scenario("a2a-2x2x2-ref", (2, 2, 2), "a2a", False),
        Scenario("a2a-2x2x2-kernels", (2, 2, 2), "a2a", True),
        Scenario("a2a_pipelined-2x2x2-kernels", (2, 2, 2), "a2a_pipelined",
                 True, num_chunks=2),
        Scenario("gather-2x2x2-ref", (2, 2, 2), "gather", False),
        Scenario("einsum-2x2x2", (2, 2, 2), "einsum", False),
        Scenario("a2a-unit-mesh-fused", (1,), "a2a", True),
        Scenario("a2a-2x2-wire-bf16", (2, 2), "a2a", True,
                 a2a_dtype="bfloat16"),
        Scenario("a2a-2x2-wire-int8", (2, 2), "a2a", True,
                 wire_codec="int8"),
        Scenario("a2a-2x2x2-wire-fp8e4m3", (2, 2, 2), "a2a", True,
                 wire_codec="fp8e4m3"),
    )


@dataclasses.dataclass(frozen=True)
class Collective:
    """A collective's signature.  On *expected* entries, ``None`` fields
    are wildcards."""

    kind: str
    dtype: str | None = None
    elements: int | None = None
    groups: tuple | None = None

    def describe(self) -> str:
        parts = [self.kind]
        if self.dtype is not None:
            parts.append(f"dtype={self.dtype}")
        if self.elements is not None:
            parts.append(f"elements={self.elements}")
        if self.groups is not None:
            parts.append(f"groups={list(map(list, self.groups))}")
        return " ".join(parts)


def axis_groups(names, sizes, axes) -> tuple:
    """Rank groups of the axis ``axes`` (a name, or a tuple of names):
    ranks numbered row-major over the world, grouped by fixing every
    other axis."""
    import numpy as np

    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    ids = np.arange(math.prod(sizes)).reshape(sizes)
    ks = [names.index(a) for a in axes]
    rest = [i for i in range(len(sizes)) if i not in ks]
    rows = ids.transpose(rest + ks).reshape(
        -1, math.prod(sizes[k] for k in ks))
    return tuple(sorted(tuple(int(x) for x in row) for row in rows))


# ---------------------------------------------------------------------------
# expected inventory (computed from the modules the engine uses)
# ---------------------------------------------------------------------------


def _plan(sc: Scenario):
    from repro_torch.core.capacity import make_dispatch_plan
    return make_dispatch_plan(
        tokens_per_device=sc.tokens, num_experts=sc.num_experts,
        top_k=sc.top_k, capacity_factor=sc.capacity_factor,
        axis_sizes=sc.axis_sizes, mode="ta")


def expected_inventory(sc: Scenario, device="cpu") -> list:
    from repro_torch.core.dispatch import transport
    from repro_torch.core.dispatch.base import EPSpec
    from repro_torch.kernels.moe_fused import ops as fused_ops
    from repro_torch.kernels.moe_gemm import ops as gemm_ops

    names, sizes = sc.axis_names, sc.axis_sizes
    T, d, N = sc.tokens, sc.d_model, sc.num_experts
    ep_world = math.prod(sizes)
    E_l = N // ep_world
    groups_of = {a: axis_groups(names, sizes, a) for a in names}

    if sc.path == "einsum":
        return []

    if sc.path == "gather":
        live = tuple(a for a, s in zip(names, sizes) if s > 1)
        if not live:
            return []
        g = axis_groups(names, sizes, live)
        dt = hlo_dtype(sc.dtype)
        return [Collective("all_gather", dt, T * d, g),
                Collective("all_reduce", dt, T * ep_world * d, g)]

    # staged a2a paths
    plan = _plan(sc)
    stages = transport.plan_stages(plan, EPSpec.from_axes(names, sizes))
    fused_on = fused_ops.use_fused(sc.use_pallas, device)
    ragged = gemm_ops.use_ragged(sc.use_pallas, device)
    codec = scenario_codec(sc)
    wire_dt = hlo_dtype(codec.wire_dtype if codec else sc.dtype)
    scaled = codec is not None and codec.scaled
    nc = max(1, sc.num_chunks)

    exp = []
    for stage in stages:
        if fused_on and stage.num_dests == 1:
            continue  # fused local path: zero collectives for this stage
        cap_eff = min(int(stage.cap), T)       # routing.select's clamp
        aligned = -(-cap_eff // nc) * nc       # routing.pad_selection
        cpc = aligned // nc
        payload = stage.num_dests * E_l * cpc * d
        counts = stage.num_dests * E_l
        for ax, size in zip(stage.axis_names, stage.axis_sizes):
            if size == 1:
                continue  # a hop over one rank exchanges nothing
            for _ in range(nc):
                # dispatch hop + combine hop, both in the wire dtype
                exp.append(Collective("all_to_all", wire_dt, payload,
                                      groups_of[ax]))
                exp.append(Collective("all_to_all", wire_dt, payload,
                                      groups_of[ax]))
                if scaled:
                    # f32 scale sideband: one exchange per payload
                    # exchange, shaped like the count tensor
                    exp.append(Collective("all_to_all", "f32", counts,
                                          groups_of[ax]))
                    exp.append(Collective("all_to_all", "f32", counts,
                                          groups_of[ax]))
                if ragged:
                    # valid-count exchange on the same chain, exact i32
                    exp.append(Collective("all_to_all", "i32", counts,
                                          groups_of[ax]))
    return exp


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def inventory(world) -> list:
    """A recording world's log as :class:`Collective` entries (ranks
    numbered with the ``model`` axis innermost where the world has
    one)."""
    names, sizes = world.axis_names, world.axis_sizes
    if getattr(world, "model", 1) > 1:
        names, sizes = names + ("model",), sizes + (world.model,)
    return [Collective(kind, hlo_dtype(dtype), int(n),
                       axis_groups(names, sizes, axes))
            for kind, dtype, n, axes in world.log]


def scenario_codec(sc: Scenario):
    """The scenario's wire codec as ``MoEConfig`` resolves it: the
    first-class ``wire_codec`` name wins, the deprecated ``a2a_dtype``
    falls back to the cast-only codec (no warning here: the analysis
    exercises the alias deliberately)."""
    from repro_torch.core.dispatch import wire
    if sc.wire_codec:
        return wire.get_codec(sc.wire_codec)
    if sc.a2a_dtype:
        return wire.cast_codec(sc.a2a_dtype)
    return None


def _scenario_inputs(sc: Scenario, world, *, device="cpu", seed: int = 0):
    """``(engine, params, x)`` of one scenario on ``world`` (rank
    ``world.rank``): the layer's parameters drawn from ``seed`` on every
    rank alike, its expert shard kept (every expert for the shard-local
    einsum baseline), and this rank's [T, d] tokens."""
    import torch

    from repro_torch.core import gating
    from repro_torch.core.dispatch import engine as dispatch_lib
    from repro_torch.core.dispatch.base import (EXPERT_PARAMS, EPSpec,
                                                MoEConfig, init_moe_params)

    names, sizes = sc.axis_names, sc.axis_sizes
    dtype = getattr(torch, sc.dtype)
    cfg = MoEConfig(d_model=sc.d_model, d_ff=sc.d_ff,
                    num_experts=sc.num_experts, top_k=sc.top_k,
                    capacity_factor=sc.capacity_factor,
                    activation=sc.activation, dtype=dtype,
                    wire_codec=scenario_codec(sc))
    ep = EPSpec.from_axes(names, sizes)
    gate_cfg = gating.GateConfig(num_experts=sc.num_experts, top_k=sc.top_k,
                                 aux_mode="lb")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_moe_params(cfg, ep, gate_cfg, gen, device)
    if sc.path != "einsum":
        E_l = sc.num_experts // ep.ep_world
        lo = world.rank * E_l
        for name in EXPERT_PARAMS:
            if name in params:
                params[name] = params[name][lo:lo + E_l].contiguous()
    xs = torch.randn((ep.ep_world, sc.tokens, sc.d_model), generator=gen,
                     device=device, dtype=torch.float32)
    x = xs[world.rank].to(dtype)
    kwargs = {}
    if sc.path in ("a2a", "a2a_pipelined"):
        kwargs["plan"] = _plan(sc)
    if sc.path == "einsum":
        kwargs["capacity"] = sc.tokens
    eng = dispatch_lib.make_engine(sc.path, cfg=cfg, ep=ep,
                                   gate_cfg=gate_cfg,
                                   num_chunks=sc.num_chunks,
                                   use_pallas=sc.use_pallas, world=world,
                                   **kwargs)
    return eng, params, x


def record_scenario(sc: Scenario, world=None, *, device="cpu",
                    seed: int = 0) -> list:
    """Run one forward of the scenario's engine through a recording world
    and return its collective inventory.  ``world``: a real rank's
    ``EPWorld`` to pass the calls through (its sizes must be the
    scenario's); None emulates rank 0 in this process."""
    import torch

    from repro_torch.launch import mesh

    rw = (mesh.recording_world(sc.axis_sizes, device=device) if world is None
          else mesh.recording_world(inner=world))
    if tuple(rw.axis_sizes) != tuple(sc.axis_sizes):
        raise ValueError(f"{sc.name}: world {rw.axis_sizes} is not the "
                         f"scenario's {sc.axis_sizes}")
    eng, params, x = _scenario_inputs(sc, rw, device=device, seed=seed)
    with torch.no_grad():
        y, _ = eng(params, x)
    if tuple(y.shape) != tuple(x.shape):
        raise RuntimeError(f"{sc.name}: output {tuple(y.shape)} for input "
                           f"{tuple(x.shape)}")
    return inventory(rw)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------


def _matches(exp: Collective, act: Collective) -> bool:
    if exp.kind != act.kind:
        return False
    return all(getattr(exp, f) is None or getattr(exp, f) == getattr(act, f)
               for f in ("dtype", "elements", "groups"))


def match_inventory(where: str, expected, actual) -> list:
    """Greedy multiset match; every miss in either direction is a
    violation (so stray collectives fail even when all expected ones are
    present)."""
    violations = []
    remaining = list(actual)
    for exp in expected:
        hit = next((a for a in remaining if _matches(exp, a)), None)
        if hit is None:
            violations.append(Violation(
                "collective", "collective-inventory", where,
                f"missing expected collective: {exp.describe()}"))
        else:
            remaining.remove(hit)
    for act in remaining:
        violations.append(Violation(
            "collective", "collective-inventory", where,
            f"unexpected collective in the recording: {act.describe()}"))
    return violations


def verify(sc: Scenario, expected=None, actual=None) -> list:
    """Record one scenario and diff its inventory against the
    plan-derived expectation (``expected`` overrides it — fixtures use
    this to prove the check fires; ``actual``, a recording made
    elsewhere, e.g. on a real world)."""
    if expected is None:
        expected = expected_inventory(sc)
    if actual is None:
        actual = record_scenario(sc)
    return match_inventory(sc.name, expected, actual)


def run(scenarios=None) -> tuple:
    if scenarios is None:
        scenarios = default_scenarios()
    violations, covered = [], []
    for sc in scenarios:
        covered.append(sc.name)
        violations.extend(verify(sc))
    return violations, covered
