"""The pipelined a2a path of the port against the JAX package on the CPU.

- ``comm_model``: ``pipelined_time``, ``estimate_overlap``,
  ``choose_num_chunks``, ``stage_overlap_terms`` and ``moe_overlap_terms``
  over the reference tests' plans and wires: equal (same float64
  arithmetic), the chunk verdicts identical; the full-width
  ``gpt3_medium_moe`` 2x2 plan (seq 512, batch 8) picks 8 chunks under
  every wire in both packages.
- ``build_ctx(dispatch="a2a_pipelined")``: the resolved chunk count and
  the chunk-aligned plan equal the reference's, for a fixed and an
  automatic count.
- The ``a2a_pipelined`` engine on the unit world at 1, 2 and 4 chunks
  under the raw, ``bf16``, ``int8`` and ``fp8e4m3`` wires, kernel branch
  off (permute -> scaled chain -> int8 grouped FFN -> scaled chain ->
  unpermute, plain) and on (the fused local branch; the JAX kernels run
  under the Pallas interpreter): output, every ``METRIC_KEYS`` entry, and
  the gradients of ``sum(y * r) + aux_loss`` to every parameter and to x.
  Tolerance rtol = atol = 1e-4 (float32; the codecs' payloads are
  bit-equal, see ``test_torch_wire.py``, so only sums in another order
  differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.compat import shard_map
from repro.configs.base import get_config as jax_get_config
from repro.core import capacity as jcap
from repro.core import comm_model as jcomm
from repro.core import dispatch as jdispatch
from repro.core import gating as jgating
from repro.models import model as jmodel
from repro_torch.configs.base import get_config
from repro_torch.core import capacity, comm_model, gating
from repro_torch.core.dispatch import base, engine
from repro_torch.models import model

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
WIRES = ("", "bf16", "int8", "fp8e4m3")


def close(got, want, **tol):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# comm_model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("td,tg,tc,k,alpha", [(4.0, 6.0, 4.0, 1, 0.5),
                                              (4.0, 6.0, 4.0, 3, 0.0),
                                              (1.0, 8.0, 1.0, 8, 1e-3),
                                              (2.5e-4, 1e-4, 2.5e-4, 4, 1e-5)])
def test_pipeline_time_model_equal(td, tg, tc, k, alpha):
    assert comm_model.pipelined_time(td, tg, tc, k, alpha=alpha) == \
        jcomm.pipelined_time(td, tg, tc, k, alpha=alpha)
    got = comm_model.estimate_overlap(t_exchange=td, t_compute=tg,
                                      alpha=alpha, num_chunks=k)
    want = jcomm.estimate_overlap(t_exchange=td, t_compute=tg, alpha=alpha,
                                  num_chunks=k)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.overlapped_fraction == want.overlapped_fraction
    for kw in (dict(t_exchange=td, t_compute=tg, alpha=alpha),
               dict(t_exchange=1e-6, t_compute=1e-6, alpha=1.0),
               dict(t_exchange=1.0, t_compute=8.0, alpha=0.0)):
        assert comm_model.choose_num_chunks(**kw) == \
            jcomm.choose_num_chunks(**kw)


PLANS = [  # (plan keywords, d_model, d_ff, bytes_per_el, activation)
    (dict(tokens_per_device=4096, num_experts=16, top_k=2,
          capacity_factor=1.0, axis_sizes=(2, 4), mode="ta",
          round_multiple=1), 64, 128, 4, "swiglu"),
    (dict(tokens_per_device=512, num_experts=32, top_k=2,
          capacity_factor=2.0, axis_sizes=(4, 8), mode="ta"),
     1024, 2048, 2, "swiglu"),
    (dict(tokens_per_device=64, num_experts=16, top_k=2,
          capacity_factor=2.0, axis_sizes=(2, 2), mode="ta"),
     64, 128, 4, "gelu"),
    (dict(tokens_per_device=256, num_experts=8, top_k=2,
          capacity_factor=1.5, axis_sizes=(2, 2, 2), mode="hir"),
     32, 64, 2, "gelu"),
]


@pytest.mark.parametrize("case", range(len(PLANS)))
@pytest.mark.parametrize("codec", WIRES)
def test_overlap_terms_and_verdicts_equal(case, codec):
    kw, d, f, bpe, act = PLANS[case]
    plan = capacity.make_dispatch_plan(**kw)
    jplan = jcap.make_dispatch_plan(**kw)
    assert comm_model.stage_overlap_terms(plan, d_model=d, bytes_per_el=bpe,
                                          codec=codec) == \
        jcomm.stage_overlap_terms(jplan, d_model=d, bytes_per_el=bpe,
                                  codec=codec)
    got = comm_model.moe_overlap_terms(plan, d_model=d, d_ff=f,
                                       bytes_per_el=bpe, activation=act,
                                       codec=codec)
    want = jcomm.moe_overlap_terms(jplan, d_model=d, d_ff=f,
                                   bytes_per_el=bpe, activation=act,
                                   codec=codec)
    assert got == want
    assert comm_model.choose_num_chunks(**got) == \
        jcomm.choose_num_chunks(**want)


def test_codec_swap_changes_the_verdict_as_in_reference():
    """The reference's acceptance case (bf16 -> int8 at matched shapes
    flips the chunk count), reached by both packages alike."""
    kw, d, f, bpe, _ = PLANS[1]
    plan = capacity.make_dispatch_plan(**kw)
    verdicts = {c: comm_model.choose_num_chunks(**comm_model.moe_overlap_terms(
        plan, d_model=d, d_ff=f, bytes_per_el=bpe, codec=c))
        for c in ("bf16", "int8")}
    jplan = jcap.make_dispatch_plan(**kw)
    jverdicts = {c: jcomm.choose_num_chunks(**jcomm.moe_overlap_terms(
        jplan, d_model=d, d_ff=f, bytes_per_el=bpe, codec=c))
        for c in ("bf16", "int8")}
    assert verdicts == jverdicts
    assert verdicts["int8"] < verdicts["bf16"]


def test_links_and_exchange_simulation_equal():
    from repro.core import topology as jtopo
    from repro_torch.core import topology
    jm, m = jtopo.tpu_topology(2, 4), topology.tpu_topology(2, 4)
    for mode in ("even", "ta"):
        c_hat = (None if mode == "even" else
                 jtopo.target_dispatch(jm, 512.0))
        jc = jcomm.dispatch_matrix_from_ratios(jm, 512.0, 2048.0, mode=mode,
                                               c_hat=c_hat)
        c = comm_model.dispatch_matrix_from_ratios(m, 512.0, 2048.0,
                                                   mode=mode, c_hat=c_hat)
        np.testing.assert_array_equal(c, jc)
        got, want = comm_model.simulate_exchange(m, c), \
            jcomm.simulate_exchange(jm, jc)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    jl = {"pod": jcomm.LinkEstimate(1e-5, 2e-10, (1, 2), (0.1, 0.2)),
          "data": None}
    li = {k: (None if v is None else comm_model.LinkEstimate(
        *dataclasses.astuple(v))) for k, v in jl.items()}
    mult = {"pod": 3.0}
    got, want = comm_model.scale_links(li, mult), jcomm.scale_links(jl, mult)
    assert {k: v and dataclasses.astuple(v) for k, v in got.items()} == \
        {k: v and dataclasses.astuple(v) for k, v in want.items()}
    assert comm_model.link_slowdowns(got, li) == jcomm.link_slowdowns(want,
                                                                      jl)
    plan = capacity.make_dispatch_plan(**PLANS[2][0])
    jplan = jcap.make_dispatch_plan(**PLANS[2][0])
    assert comm_model.moe_overlap_terms(plan, d_model=64, d_ff=128,
                                        bytes_per_el=4, links=li) == \
        jcomm.moe_overlap_terms(jplan, d_model=64, d_ff=128, bytes_per_el=4,
                                links=jl)


def test_full_width_2x2_plan_picks_8_chunks(mesh11):
    """gpt3_medium_moe at seq 512, batch 8 on a (2, 2) EP world: caps
    (120, 16) and 8 chunks under every wire, in both packages."""
    arch = get_config("gpt3_medium_moe")
    plan = capacity.make_dispatch_plan(
        tokens_per_device=1024, num_experts=64, top_k=2,
        capacity_factor=arch.moe.capacity_factor, axis_sizes=(2, 2),
        mode="ta")
    jplan = jcap.make_dispatch_plan(
        tokens_per_device=1024, num_experts=64, top_k=2,
        capacity_factor=arch.moe.capacity_factor, axis_sizes=(2, 2),
        mode="ta")
    assert plan.caps == jplan.caps == (120, 16)
    for codec in WIRES:
        terms = comm_model.moe_overlap_terms(
            plan, d_model=1024, d_ff=2048, bytes_per_el=2,
            activation="gelu", codec=codec)
        assert terms == jcomm.moe_overlap_terms(
            jplan, d_model=1024, d_ff=2048, bytes_per_el=2,
            activation="gelu", codec=codec)
        assert comm_model.choose_num_chunks(**terms) == 8
        assert model.resolve_num_chunks(arch, plan, wire_codec=codec) == 8
    aligned = capacity.align_to_chunks(plan, 8)
    assert aligned.caps == (120, 16)
    assert [aligned.chunk_cap(s) for s in range(2)] == [15, 2]


# ---------------------------------------------------------------------------
# build_ctx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks,codec", [(3, ""), (0, ""), (0, "int8"),
                                          (2, "fp8e4m3")])
def test_build_ctx_resolves_chunks_and_aligned_plan(mesh11, chunks, codec):
    kw = dict(seq_len=32, global_batch=4, aux_mode="ta",
              dispatch="a2a_pipelined", a2a_num_chunks=chunks,
              wire_codec=codec)
    jctx = jmodel.build_ctx(jax_get_config("gpt3_medium_moe").reduced(),
                            mesh11, **kw)
    ctx = model.build_ctx(get_config("gpt3_medium_moe").reduced(),
                          device="cpu", **kw)
    assert ctx.dispatch == jctx.dispatch == "a2a_pipelined"
    assert ctx.a2a_num_chunks == jctx.a2a_num_chunks
    if chunks:
        assert ctx.a2a_num_chunks == chunks
    assert ctx.plan.num_chunks == jctx.plan.num_chunks == ctx.a2a_num_chunks
    assert ctx.plan.caps == jctx.plan.caps
    assert all(c % ctx.a2a_num_chunks == 0 for c in ctx.plan.caps if c)
    assert (ctx.wire_codec and ctx.wire_codec.name) == \
        (jctx.wire_codec and jctx.wire_codec.name)
    sync = model.build_ctx(ctx.arch, seq_len=32, global_batch=4,
                           device="cpu")
    assert sync.a2a_num_chunks == 1 and sync.plan.num_chunks == 1


# ---------------------------------------------------------------------------
# the engine on the unit world
# ---------------------------------------------------------------------------

D, F, N, K, T = 16, 32, 4, 2, 64
CF = 0.9            # caps 29: not a multiple of 2 or 4, and some drops


@pytest.fixture(scope="module")
def unit_case():
    jcfg = jdispatch.MoEConfig(d_model=D, d_ff=F, num_experts=N, top_k=K,
                               capacity_factor=CF, dtype=jnp.float32)
    jep = jdispatch.EPSpec.from_axes(("data",), (1,))
    jgate = jgating.GateConfig(num_experts=N, top_k=K, aux_mode="lb")
    jparams = jdispatch.init_moe_params(jax.random.PRNGKey(0), jcfg, jep,
                                        jgate)
    plan_kw = dict(tokens_per_device=T, num_experts=N, top_k=K,
                   capacity_factor=CF, num_pods=1, ep_per_pod=1,
                   mode="even", round_multiple=1)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, D)).astype(np.float32)
    r = rng.standard_normal((T, D)).astype(np.float32)
    return (jcfg, jep, jgate, jcap.make_plan(**plan_kw),
            jax.tree_util.tree_map(np.asarray, jparams),
            capacity.make_plan(**plan_kw), x, r)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("codec", WIRES)
@pytest.mark.parametrize("num_chunks", [1, 2, 4])
def test_pipelined_engine_matches_reference(mesh11, unit_case, num_chunks,
                                            codec, use_pallas):
    jcfg, jep, jgate, jplan, params, plan, x, r = unit_case
    assert plan.caps == jplan.caps == (29,)
    jeng = jdispatch.make_engine(
        "a2a_pipelined", cfg=dataclasses.replace(jcfg, wire_codec=codec),
        ep=jep, gate_cfg=jgate, plan=jplan, num_chunks=num_chunks,
        use_pallas=use_pallas)

    def jloss(p, xx):
        y, m = jeng(p, xx)
        return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)
    fn = jax.jit(shard_map(jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True),
                           mesh=mesh11, in_specs=(P(), P()), out_specs=P(),
                           check_vma=False))
    with mesh11:
        (_, (jy, jm)), (jgp, jgx) = fn(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    cfg = base.MoEConfig(d_model=D, d_ff=F, num_experts=N, top_k=K,
                         capacity_factor=CF, dtype=torch.float32,
                         wire_codec=codec)
    eng = engine.make_engine(
        "a2a_pipelined", cfg=cfg, ep=base.EPSpec(),
        gate_cfg=gating.GateConfig(num_experts=N, top_k=K, aux_mode="lb"),
        plan=plan, num_chunks=num_chunks, use_pallas=use_pallas)
    assert eng.num_chunks == num_chunks
    p = {"gate": {"w": t(params["gate"]["w"]).requires_grad_(True)}}
    for k in ("w_in", "w_gate", "w_out"):
        p[k] = t(params[k]).requires_grad_(True)
    xt = t(x).requires_grad_(True)
    y, m = eng(p, xt)
    (torch.sum(y * t(r)) + m["aux_loss"]).backward()
    close(y, jy)
    assert set(m) == set(engine.METRIC_KEYS) == set(jm)
    for k in engine.METRIC_KEYS:
        close(m[k], jm[k])
    close(xt.grad, jgx)
    close(p["gate"]["w"].grad, jgp["gate"]["w"])
    for k in ("w_in", "w_gate", "w_out"):
        close(p[k].grad, jgp[k])


# ---------------------------------------------------------------------------
# a 2x2 (pod x data) EP world: one JAX subprocess on 4 forced host devices
# against 4 gloo processes of the port (as test_torch_multirank.py)
# ---------------------------------------------------------------------------

SEQ, BATCH, CHUNKS = 32, 8, 2
SIZES = (2, 2)
SCALED = ("int8", "fp8e4m3")
# (wire, kernel branch) of the trainer steps: the chip's path (int8, the
# ragged branch), int8 with kernels off (the chip's plain path), and the
# fp8 wire with kernels off
TRAIN_CASES = (("int8", True), ("int8", False), ("fp8e4m3", False))

REFERENCE = f"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import RunConfig, get_config
from repro.models import model, transformer
from repro.training import trainer

mesh = make_mesh({SIZES + (1,)}, ("pod", "data", "model"))
arch = get_config("gpt3_medium_moe").reduced()
kw = dict(seq_len={SEQ}, global_batch={BATCH}, aux_mode="ta",
          dispatch="a2a_pipelined", a2a_num_chunks={CHUNKS})
rules = model.default_rules(mesh)
ctx0 = model.build_ctx(arch, mesh, **kw)
with mesh, sharding.axis_rules(rules):
    params = model.init_params(jax.random.PRNGKey(0), ctx0, rules=rules)
rng = np.random.default_rng(5)
x = rng.standard_normal(({BATCH}, {SEQ}, arch.d_model)).astype(np.float32)
r = rng.standard_normal(x.shape).astype(np.float32)
p1 = jax.tree_util.tree_map(lambda a: a[1], params["groups"])["sub0"]["ffn"]
out = {{"params": jax.tree_util.tree_map(np.asarray, params),
        "caps": ctx0.plan.caps, "x": x, "r": r}}
for codec in {SCALED!r}:
    for use_pallas in (None, True):
        ctx = model.build_ctx(arch, mesh, wire_codec=codec,
                              use_pallas=use_pallas, **kw)

        def loss(p, xx):
            y, m = transformer._moe_block(p, xx, ctx, decode=False,
                                          layer_idx=1)
            return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)

        with mesh:
            (_, (y, m)), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p1, jnp.asarray(x))
        out[codec, bool(use_pallas)] = {{
            "y": np.asarray(y),
            "metrics": {{k: np.asarray(v) for k, v in m.items()}},
            "grads": jax.tree_util.tree_map(np.asarray, g)}}
for codec, use_pallas in {TRAIN_CASES!r}:
    run = RunConfig(seq_len={SEQ}, global_batch={BATCH}, warmup_steps=1,
                    aux_mode="ta", dispatch="a2a_pipelined",
                    a2a_num_chunks={CHUNKS}, wire_codec=codec, seed=0,
                    use_pallas=use_pallas or None)
    res = trainer.train(arch, run, mesh, steps=1, log_every=1,
                        verbose=False)
    out["train", codec, use_pallas] = {{
        "history": res.metrics_history,
        "final": jax.tree_util.tree_map(np.asarray, res.params)}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _rank_main(world, ref_path, out_dir):
    """One rank of the port's world: the engine under each scaled wire with
    the kernel branch off and on, and the trainer steps."""
    import os
    import pickle
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    arch = get_config("gpt3_medium_moe").reduced()
    per = BATCH // world.size
    rows = slice(world.rank * per, (world.rank + 1) * per)
    out = {"rank": world.rank}
    for codec in SCALED:
        for use_pallas in (False, True):
            ctx = model.build_ctx(arch, world, seq_len=SEQ,
                                  global_batch=BATCH, aux_mode="ta",
                                  dispatch="a2a_pipelined",
                                  a2a_num_chunks=CHUNKS, wire_codec=codec,
                                  use_pallas=use_pallas, device="cpu")
            params = params_from_numpy(ref["params"], ctx, "cpu")
            p = {k: (v.requires_grad_(True) if torch.is_tensor(v)
                     else {kk: vv.requires_grad_(True)
                           for kk, vv in v.items()})
                 for k, v in params["layers"][1]["ffn"].items()}
            x = torch.from_numpy(ref["x"][rows].copy()).requires_grad_(True)
            y, m = transformer._moe_block(p, x, ctx, decode=False,
                                          layer_idx=1)
            (torch.sum(y * torch.from_numpy(ref["r"][rows].copy()))
             + m["aux_loss"] / world.size).backward()
            out[codec, use_pallas] = {
                "caps": ctx.plan.caps, "chunks": ctx.a2a_num_chunks,
                "y": y.detach().numpy(),
                "metrics": {k: v.detach().numpy() for k, v in m.items()},
                "gx": x.grad.numpy(),
                "g_gate": world.all_reduce_sum(p["gate"]["w"].grad).numpy(),
                "g_w_in": p["w_in"].grad.numpy(),
                "g_w_out": p["w_out"].grad.numpy()}
    for codec, use_pallas in TRAIN_CASES:
        run = RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                        aux_mode="ta", dispatch="a2a_pipelined",
                        a2a_num_chunks=CHUNKS, wire_codec=codec, seed=0,
                        use_pallas=use_pallas)
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              device="cpu")
        res = trainer.train(arch, run, world, steps=1, log_every=1,
                            verbose=False,
                            params=params_from_numpy(ref["params"], ctx,
                                                     "cpu"),
                            device="cpu")
        out["train", codec, use_pallas] = {
            "history": res.metrics_history,
            "final": [a.detach().numpy()
                      for a in adamw.tree_leaves(res.params)]}
    with open(os.path.join(out_dir, f"rank{world.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    """(reference results, [rank 0..3 results])."""
    import os
    import pickle
    import subprocess
    import sys
    import textwrap
    from repro_torch.launch import mesh
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tmp_path_factory.mktemp("pipelined22")
    ref_path = str(tmp / "reference.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(repo, "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        ref_path], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    mesh.spawn(_rank_main, SIZES, "gloo", "cpu", args=(ref_path, str(tmp)))
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for i in range(4):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def close_but_flips(got, want, *, level, frac, tol=TOL):
    """The scaled wires' tolerance: every element within ``TOL`` but a
    share ``frac``, and those within ``level`` more.  A value that the two
    frameworks sum in another order can fall on the other side of a
    quantization boundary and decode one level apart (about one such value
    in 10^5 on these shapes)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    off = err > tol["atol"] + tol["rtol"] * np.abs(want)
    assert off.mean() <= frac, (off.sum(), off.size, err.max())
    assert (err <= tol["atol"] + level).all(), (err.max(), level)


#: one level of each scaled wire, as a share of a block's largest value
#: (int8: 1 / 127; float8_e4m3fn: 3 mantissa bits, 1 / 8 of the value)
LEVEL = {"int8": 1 / 127, "fp8e4m3": 1 / 8}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("codec", SCALED)
def test_world_engine_matches_reference(world_runs, codec, use_pallas):
    """Output, metrics and gradients of the 2x2 world's pipelined engine
    under a scaled wire (the fp8 payload crosses gloo as its bytes), the
    kernel branch off and on (ragged + K7's plain version against the
    reference's interpreted kernels).

    Metrics and expert-weight gradients: ``TOL``.  The output: ``TOL`` but
    for 0.1% of the elements, which may sit one wire level (of the largest
    output) apart.  The gradients to x and the gate weights read the
    decoded expert outputs through the combine weights, so one such value
    moves its token's whole gate-logit cotangent: ``TOL`` plus 1e-3 of the
    largest entry (measured: 3.6e-4 for x, 1.1e-4 for the gate)."""
    ref, ranks = world_runs
    want = ref[codec, use_pallas]

    def grad_close(got, w):
        close_but_flips(got, w, level=1e-3 * np.abs(w).max(), frac=1.0)

    for out in ranks:
        got = out[codec, use_pallas]
        assert got["caps"] == ref["caps"] and got["chunks"] == CHUNKS
        for k in engine.METRIC_KEYS:      # world means: equal on every rank
            close(got["metrics"][k], want["metrics"][k])
        grad_close(got["g_gate"], want["grads"][0]["gate"]["w"])
    close_but_flips(np.concatenate([o[codec, use_pallas]["y"]
                                    for o in ranks]), want["y"],
                    level=LEVEL[codec] * np.abs(want["y"]).max(), frac=1e-3)
    grad_close(np.concatenate([o[codec, use_pallas]["gx"] for o in ranks]),
               want["grads"][1])
    for k in ("w_in", "w_out"):
        close(np.concatenate([o[codec, use_pallas][f"g_{k}"]
                              for o in ranks]), want["grads"][0][k])


@pytest.mark.parametrize("codec,use_pallas", TRAIN_CASES)
def test_world_trainer_step_matches_reference(world_runs, codec, use_pallas):
    """One trainer step: loss, nll, aux, fractions, grad norm within
    ``TOL``; final params within atol 2e-4 (``test_torch_training.py``)
    but for 0.1%, which may differ by 2 lr: AdamW's first step moves a
    weight by lr times the sign of its gradient, and a gradient near 0 can
    change sign with a value decoded one wire level apart."""
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    ref, ranks = world_runs
    want = ref["train", codec, bool(use_pallas)]
    arch = get_config("gpt3_medium_moe").reduced()
    for out in ranks:
        got = out["train", codec, use_pallas]
        assert len(got["history"]) == len(want["history"]) == 1
        for k in ("loss", "nll", "aux", "frac_by_level", "dropped",
                  "grad_norm", "lr"):
            close(got["history"][0][k], want["history"][0][k])
        world = EPWorld(axis_names=("pod", "data"), axis_sizes=SIZES,
                        coords=divmod(out["rank"], SIZES[1]))
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              device="cpu")
        final = adamw.tree_leaves(params_from_numpy(want["final"], ctx,
                                                    "cpu"))
        assert len(final) == len(got["final"])
        for a, b in zip(got["final"], final):
            close_but_flips(a, b, level=2 * 3e-4, frac=1e-3,
                            tol=dict(rtol=1e-4, atol=2e-4))


def test_world_int8_kernel_branch_loss_gap(world_runs):
    """Under the int8 wire the kernel branch quantizes each (expert, stage,
    source) segment with its own scale, the plain branch each expert's
    chunk span with one: the first-step losses differ by more than
    rounding.  The gap (1.3e-4 relative on this 2-layer model, equal in
    both packages), grown over the chip's 12 layers, must stay inside the
    chip's tolerance between its kernel and plain paths,
    ``chip_smoke.LOSS_RTOL_INT8``."""
    import importlib.util
    import os
    ref, ranks = world_runs
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def gap(src):
        on = float(src["train", "int8", True]["history"][0]["loss"])
        off = float(src["train", "int8", False]["history"][0]["loss"])
        return abs(on - off) / abs(off)
    gaps = [gap(ref)] + [gap(out) for out in ranks]
    assert max(gaps) - min(gaps) <= 1e-5, gaps
    # the chip's model has 6 times the layers
    assert 0 < 6 * max(gaps) <= chip_smoke.LOSS_RTOL_INT8, gaps
