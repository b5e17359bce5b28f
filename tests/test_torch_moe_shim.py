"""The port's deprecated MoE surfaces against the JAX package's (the
counterpart of ``tests/test_moe_shim.py``).

- ``repro_torch.core.moe``: each ``moe_apply_*`` wrapper warns
  ``DeprecationWarning`` naming itself, returns the engine's uniform
  metrics schema, equals ``dispatch_moe``'s output bit for bit, and the
  reference's wrapper's (run under ``shard_map`` on the (1, 1) mesh) at
  rtol = atol = 1e-4 (float32).
- The ``a2a_dtype=`` / ``wire_dtype=`` keywords (``MoEConfig``,
  ``ModelCtx``, ``A2ATransport``, ``wire_a2a``) and ``wire.resolve``:
  each warns with the reference's text at the caller's line, and
  resolves to the reference's cast codec (name, wire dtype, and the
  payload dtype it encodes to); ``codec=`` wins over the keyword.
  ``wire_a2a`` on a 2-rank gloo world: the tiled all-to-all with split
  and concat axes apart, with and without the cast, and its backward
  (the transpose).
- The 2-level aliases: ``cap_near`` / ``cap_far`` / ``chunk_near`` /
  ``chunk_far`` equal the reference's and ``caps[0]`` / ``caps[1]``;
  ``Routing.near`` / ``far`` are the stage-0 / stage-1 selections; the
  transport's ``dispatch_near`` / ``dispatch_far`` / ``combine_near`` /
  ``combine_far`` equal ``dispatch`` / ``combine`` at stage 0 / 1 over the
  reference's chains; ``gating.expert_levels`` equals the reference's.
"""

import dataclasses
import os
import pickle
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.compat import shard_map
from repro.core import capacity as jcap
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.core.dispatch import transport as jtransport
from repro.core.dispatch import wire as jwire
from repro_torch.core import capacity, gating, moe
from repro_torch.core.dispatch import engine, routing, transport, wire

D, F, N, K, T = 16, 32, 4, 2, 32
TOL = dict(rtol=1e-4, atol=1e-4)
WRAPPERS = ("moe_apply_a2a", "moe_apply_a2a_pipelined", "moe_apply_gather",
            "moe_apply_einsum")
# each wrapper's path and the keywords make_engine takes for it
PATHS = {"moe_apply_a2a": ("a2a", {}),
         "moe_apply_a2a_pipelined": ("a2a_pipelined", {"num_chunks": 2}),
         "moe_apply_gather": ("gather", {}),
         "moe_apply_einsum": ("einsum", {"capacity": T})}


@pytest.fixture(scope="module")
def setup():
    """The reference's layer (its test_moe_shim.py setup) and the port's
    copy of it, float32."""
    cfg = jmoe.MoEConfig(d_model=D, d_ff=F, num_experts=N, top_k=K,
                         capacity_factor=8.0, dtype=jnp.float32)
    ep = jmoe.EPSpec(num_pods=1, ep_per_pod=1, pod_axis=None,
                     data_axis="data", model_axis="model")
    gate_cfg = jgating.GateConfig(num_experts=N, top_k=K, aux_mode="lb")
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), cfg, ep, gate_cfg)
    plan = jcap.make_plan(tokens_per_device=T, num_experts=N, top_k=K,
                          capacity_factor=8.0, num_pods=1, ep_per_pod=1,
                          mode="even")
    x = jax.random.normal(jax.random.PRNGKey(1), (T, D), jnp.float32)
    port = {
        "cfg": moe.MoEConfig(d_model=D, d_ff=F, num_experts=N, top_k=K,
                             capacity_factor=8.0, dtype=torch.float32),
        "ep": moe.EPSpec(),
        "gate_cfg": gating.GateConfig(num_experts=N, top_k=K,
                                      aux_mode="lb"),
        "params": {k: ({kk: torch.from_numpy(np.asarray(vv).copy())
                        for kk, vv in v.items()} if isinstance(v, dict)
                       else torch.from_numpy(np.asarray(v).copy()))
                   for k, v in params.items()},
        "plan": capacity.make_plan(tokens_per_device=T, num_experts=N,
                                   top_k=K, capacity_factor=8.0,
                                   num_pods=1, ep_per_pod=1, mode="even"),
        "x": torch.from_numpy(np.asarray(x).copy())}
    return (cfg, ep, gate_cfg, params, plan, x), port


def _port_call(port, wrapper):
    cfg, ep, gate_cfg, plan = (port["cfg"], port["ep"], port["gate_cfg"],
                               port["plan"])
    fn = getattr(moe, wrapper)
    p, x = port["params"], port["x"]
    return {"moe_apply_a2a": lambda: fn(p, x, cfg, ep, plan, gate_cfg),
            "moe_apply_a2a_pipelined": lambda: fn(p, x, cfg, ep, plan,
                                                  gate_cfg, num_chunks=2),
            "moe_apply_gather": lambda: fn(p, x, cfg, ep, gate_cfg),
            "moe_apply_einsum": lambda: fn(p, x, cfg, ep, gate_cfg,
                                           capacity=T)}[wrapper]()


def _reference_call(ref, wrapper, mesh):
    cfg, ep, gate_cfg, params, plan, x = ref
    fn = getattr(jmoe, wrapper)
    body = {"moe_apply_a2a": lambda p, xx: fn(p, xx, cfg, ep, plan,
                                              gate_cfg),
            "moe_apply_a2a_pipelined": lambda p, xx: fn(
                p, xx, cfg, ep, plan, gate_cfg, num_chunks=2),
            "moe_apply_gather": lambda p, xx: fn(p, xx, cfg, ep, gate_cfg),
            "moe_apply_einsum": lambda p, xx: fn(p, xx, cfg, ep, gate_cfg,
                                                 capacity=T)}[wrapper]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with mesh:
            return shard_map(body, mesh=mesh, in_specs=(P(), P()),
                             out_specs=(P(), P()), check_vma=False)(params,
                                                                    x)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_each_wrapper_warns_and_equals_the_engine(setup, mesh11, wrapper):
    """The warning names the wrapper and the caller's line; the output is
    ``dispatch_moe``'s bit for bit and the reference wrapper's at 1e-4;
    the metrics are the engine's uniform schema, equal to the
    reference's."""
    ref, port = setup
    with pytest.warns(DeprecationWarning, match=wrapper) as rec:
        y, metrics = _port_call(port, wrapper)
    assert any(w.filename == __file__ for w in rec)
    path, kw = PATHS[wrapper]
    if path in ("a2a", "a2a_pipelined"):
        kw = dict(kw, plan=port["plan"])
    y_eng, m_eng = engine.dispatch_moe(
        path, port["params"], port["x"], cfg=port["cfg"], ep=port["ep"],
        gate_cfg=port["gate_cfg"], **kw)
    assert torch.equal(y, y_eng)
    assert set(metrics) == set(engine.METRIC_KEYS)
    assert metrics["frac_by_level"].shape == (1,)
    for k in engine.METRIC_KEYS:
        assert torch.equal(metrics[k], m_eng[k]), k
    y_ref, m_ref = _reference_call(ref, wrapper, mesh11)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert set(m_ref) == set(metrics)
    for k in engine.METRIC_KEYS:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(m_ref[k]),
                                   **TOL)


def _one_warning(fn):
    """``fn()``'s result and its one DeprecationWarning."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in rec]
    return out, dep[0]


def test_wire_dtype_keywords_resolve_to_the_cast_codec():
    """``MoEConfig(a2a_dtype=)``, ``ModelCtx(a2a_dtype=).moe_cfg``,
    ``A2ATransport(wire_dtype=)`` and ``wire.resolve`` warn with the
    reference's text at this file's lines and give the reference's cast
    codec, which encodes to the same payload dtype; ``codec=`` wins and
    does not warn; an unknown dtype name is refused by name."""
    from repro.core.dispatch import base as jbase
    from repro_torch.configs.base import get_config
    from repro_torch.core.dispatch import base
    from repro_torch.models import model

    want, jw = _one_warning(lambda: jbase.MoEConfig(
        d_model=D, d_ff=F, num_experts=N, top_k=K, a2a_dtype="bfloat16"))
    want = want.wire_codec
    assert jw.filename == __file__
    payload = np.asarray(want.encode(jnp.ones((2, 3, 4)))[0])
    ctx = model.build_ctx(get_config("gpt3_medium_moe").reduced(),
                          device="cpu")
    ctx = dataclasses.replace(ctx, a2a_dtype="bfloat16")
    cases = {
        "MoEConfig": lambda: base.MoEConfig(
            d_model=D, d_ff=F, num_experts=N, top_k=K,
            a2a_dtype="bfloat16").wire_codec,
        "ModelCtx": lambda: ctx.moe_cfg.wire_codec,
        "A2ATransport": lambda: transport.A2ATransport(
            ep=base.EPSpec(), world=None, wire_dtype="bfloat16").codec,
        "resolve": lambda: wire.resolve(None, "bfloat16", stacklevel=2)}
    for name, fn in cases.items():
        got, w = _one_warning(fn)
        assert str(w.message) == str(jw.message), name
        if name != "ModelCtx":      # a property's warning names its caller
            assert w.filename == __file__, (name, w.filename)
        assert (got.name, got.wire_dtype, got.scaled) == (
            want.name, want.wire_dtype, want.scaled), name
        enc = got.encode(torch.ones((2, 3, 4)))[0]
        assert str(enc.dtype).split(".")[-1] == str(payload.dtype), name
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert wire.resolve("int8", "bfloat16") is wire.CODECS["int8"]
        assert transport.A2ATransport(ep=base.EPSpec(), world=None,
                                      codec="int8",
                                      wire_dtype="bfloat16").codec \
            is wire.CODECS["int8"]
        assert wire.resolve(None, "") is None
        assert dataclasses.astuple(wire.cast_codec("float32")) == \
            dataclasses.astuple(jwire.cast_codec("float32"))
    with pytest.raises(ValueError, match="unknown wire dtype 'bf17'"):
        wire.cast_codec("bf17")


def _wire_rank(world, out_dir):
    """One rank of the 2-rank world: ``wire_a2a`` over ``data`` with split
    axis 1 and concat axis 0, raw and over the deprecated bf16 wire, and
    the gradient of ``sum(out * r)``."""
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(world.rank)
    x = torch.randn((3, 4, 5), generator=g)
    r = torch.randn((6, 2, 5), generator=g)
    out = {"x": x.numpy(), "r": r.numpy()}
    for wd in ("", "bfloat16"):
        xx = x.clone().requires_grad_(True)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            y = transport.wire_a2a(xx, world, "data", split_axis=1,
                                   concat_axis=0, wire_dtype=wd)
        (y * r).sum().backward()
        out[wd] = {"y": y.detach().numpy(), "gx": xx.grad.numpy(),
                   "warned": sum(issubclass(w.category, DeprecationWarning)
                                 for w in rec)}
    with open(os.path.join(out_dir, f"wire{world.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def test_wire_a2a_on_a_world(tmp_path):
    """JAX's tiled all-to-all: rank j receives slice j of every rank's
    split axis, concatenated on the concat axis in rank order; the
    backward sends each cotangent slice back; ``wire_dtype="bfloat16"``
    rounds the payload to bf16 and warns once."""
    from repro_torch.launch import mesh
    mesh.spawn(_wire_rank, (2,), "gloo", "cpu", args=(str(tmp_path),))
    ranks = []
    for i in range(2):
        with open(tmp_path / f"wire{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    for j, out in enumerate(ranks):
        for wd, cast in (("", lambda a: a), ("bfloat16", bf16)):
            want = np.concatenate([cast(src["x"][:, 2 * j:2 * j + 2])
                                   for src in ranks], axis=0)
            np.testing.assert_array_equal(out[wd]["y"], want)
            assert out[wd]["warned"] == (1 if wd else 0)
            # the cotangent r of every rank, its rows from rank j's output
            gx = np.concatenate([cast(dst["r"][3 * j:3 * j + 3])
                                 for dst in ranks], axis=1)
            np.testing.assert_array_equal(out[wd]["gx"], gx)


def test_capacity_and_routing_aliases():
    """On the reduced 2x2 Eq. (7) plan and its chunk-aligned copy:
    ``cap_near``/``cap_far``/``chunk_near``/``chunk_far`` equal the
    reference's and ``caps[0]``/``caps[1]``; a one-stage plan's far
    capacity is 0; ``CapacityPlan`` names ``DispatchPlan``.  ``near`` and
    ``far`` of a route on rank 0 of the 2x2 plan are its stage-0 and
    stage-1 selections (``far`` None on the one-stage plan)."""
    from repro_torch.core.dispatch import base
    kw = dict(tokens_per_device=64, num_experts=8, top_k=2,
              capacity_factor=1.25)
    for sizes in ((2, 2), (4,)):
        want = jcap.make_dispatch_plan(axis_sizes=sizes, mode="ta", **kw)
        got = capacity.make_dispatch_plan(axis_sizes=sizes, mode="ta", **kw)
        for plan, jplan in ((got, want),
                            (capacity.align_to_chunks(got, 4),
                             jcap.align_to_chunks(want, 4))):
            aliases = ("cap_near", "cap_far", "chunk_near", "chunk_far")
            assert [getattr(plan, a) for a in aliases] == [
                getattr(jplan, a) for a in aliases]
            assert plan.cap_near == plan.caps[0]
            assert plan.cap_far == (plan.caps[1] if len(sizes) > 1 else 0)
            assert plan.chunk_near == plan.caps[0] // plan.num_chunks
        assert capacity.CapacityPlan is capacity.DispatchPlan
        cfg = base.MoEConfig(d_model=D, d_ff=F, num_experts=8, top_k=2,
                             dtype=torch.float32)
        gate_cfg = gating.GateConfig(num_experts=8, top_k=2, aux_mode="ta")
        gen = torch.Generator().manual_seed(0)
        params = {"gate": gating.init_gate_params(D, gate_cfg, gen, "cpu")}
        x = torch.randn((64, D), generator=gen)
        ep = base.EPSpec.from_axes(capacity.default_axis_names(len(sizes)),
                                   sizes)
        routed = routing.route(params, x, cfg, ep, got, gate_cfg,
                               (0,) * len(sizes))
        stages = dict(routed.sels)
        assert routed.near is stages[0]
        assert routed.far is stages.get(1)
        assert (routed.far is None) == (len(sizes) == 1)


def test_transport_near_far_are_stages_zero_and_one():
    """``dispatch_near`` / ``dispatch_far`` / ``combine_near`` /
    ``combine_far`` run stage 0's and stage 1's chains, the reference's
    (``_stage2``), and equal ``dispatch`` / ``combine`` there bit for bit
    (an exchange that keeps each rank's slice stands in for the
    all-to-alls)."""
    from repro_torch.core.dispatch import base
    sizes, names = (2, 2), ("pod", "data")
    ep = base.EPSpec.from_axes(names, sizes)
    tr = transport.A2ATransport(ep=ep, world=types.SimpleNamespace(
        all_to_all=lambda t, axis, dim: t))
    jep = types.SimpleNamespace(axis_names=names, axis_sizes=sizes)
    jtr = jtransport.A2ATransport.__new__(jtransport.A2ATransport)
    object.__setattr__(jtr, "ep", jep)
    gen = torch.Generator().manual_seed(3)
    for s in (0, 1):
        stage, jstage = tr._stage2(s), jtr._stage2(s)
        assert (stage.index, stage.axis_names, stage.axis_sizes) == (
            jstage.index, jstage.axis_names, jstage.axis_sizes)
        buf = torch.randn(stage.axis_sizes + (2, 3, D), generator=gen)
        near_far = ("near", "far")[s]
        y = getattr(tr, f"dispatch_{near_far}")(buf)
        assert torch.equal(y, tr.dispatch(buf, stage))
        back = getattr(tr, f"combine_{near_far}")(y)
        assert torch.equal(back, tr.combine(y, stage))
        assert torch.equal(back, buf)


def test_expert_levels_matches_reference():
    """The 2-level wrapper over ``expert_levels_nd``: one pod and two."""
    for ep_per_pod, num_pods in ((4, 1), (2, 2), (4, 2)):
        ranks = ep_per_pod * num_pods
        for me in range(ranks):
            pod, data = divmod(me, ep_per_pod)
            got = gating.expert_levels(2 * ranks, 2, ep_per_pod, num_pods,
                                       pod, data)
            want = jgating.expert_levels(2 * ranks, 2, ep_per_pod,
                                         num_pods, pod, data)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
