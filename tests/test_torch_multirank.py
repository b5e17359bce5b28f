"""The port on a 2x2 (pod x data) EP world against the JAX package.

One JAX subprocess on 4 forced host devices (mesh ``(2, 2, 1)`` over
``("pod", "data", "model")``, as ``tests/test_multidevice.py`` runs it)
computes the reference: the ``a2a`` engine through ``_moe_block`` on
layer 1 of ``gpt3_medium_moe.reduced()`` (float32) with the gradients of
``sum(y * r) + aux_loss``, and 2 trainer steps with ``aux_mode="ta"``.
Then 4 CPU processes of the port, joined by ``torch.distributed`` over
gloo (``launch.mesh.spawn``), run the same from the same weights, each on
its batch shard with its expert shard; the EP plan has two remote stages,
so permute -> all-to-all chain -> ragged grouped FFN -> reverse chain ->
unpermute carries every token, kernels wanted (their plain versions on
the CPU) and not.

Tolerance: rtol = atol = 1e-4 for outputs, metrics and gradients (float32,
the sums run in another order); final params atol 2e-4 (2 AdamW steps at
lr 3e-4, see ``test_torch_training.py``).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_ID = "gpt3_medium_moe"
SEQ, BATCH, STEPS = 32, 8, 2
SIZES = (2, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_KEYS = ("aux_loss", "frac_by_level", "frac_near", "frac_far",
               "dropped")
HISTORY_KEYS = ("loss", "nll", "aux", "frac_by_level", "dropped",
                "grad_norm", "lr")
# accumulation on the world: 2 microbatches of 4 rows, one row a rank each
MICRO = 4
# the reference's test_multidevice.py::test_degraded_link_replan_flips_
# dispatch_local_heavy: a 64x pod degradation from step 2, probed at step 4,
# collapses the pod level (caps (64, 0) at global batch 4)
REPLAN_STEPS = 8
REPLAN_RUN = ("dict(seq_len=32, global_batch=4, total_steps=8, "
              "warmup_steps=2, aux_mode='ta', seed=0, "
              "resilience=ResilienceConfig(replan_every=4, "
              "degrade_threshold=4.0, collapse_slowdown=64.0, "
              "chaos=ChaosConfig(degraded_links=((2, 'pod', 64.0),))))")

REFERENCE = f"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import RunConfig, get_config
from repro.models import model, transformer
from repro.training import trainer

mesh = make_mesh({SIZES + (1,)}, ("pod", "data", "model"))
arch = get_config("{ARCH_ID}").reduced()
ctx = model.build_ctx(arch, mesh, seq_len={SEQ}, global_batch={BATCH},
                      aux_mode="ta")
rules = model.default_rules(mesh)
with mesh, sharding.axis_rules(rules):
    params = model.init_params(jax.random.PRNGKey(0), ctx, rules=rules)
tree = jax.tree_util.tree_map(np.asarray, params)
rng = np.random.default_rng(5)
x = rng.standard_normal(({BATCH}, {SEQ}, arch.d_model)).astype(np.float32)
r = rng.standard_normal(x.shape).astype(np.float32)
p1 = jax.tree_util.tree_map(lambda a: a[1], params["groups"])["sub0"]["ffn"]

def loss(p, xx):
    y, m = transformer._moe_block(p, xx, ctx, decode=False, layer_idx=1)
    return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)

with mesh:
    (_, (y, m)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p1, jnp.asarray(x))
run = RunConfig(seq_len={SEQ}, global_batch={BATCH}, warmup_steps=1,
                aux_mode="ta", dispatch="a2a", seed=0)
res = trainer.train(arch, run, mesh, steps={STEPS}, log_every=1,
                    verbose=False)
micro = trainer.train(arch, RunConfig(microbatch={MICRO}, **{{
    k: getattr(run, k) for k in ("seq_len", "global_batch", "warmup_steps",
                                 "aux_mode", "dispatch", "seed")}}),
    mesh, steps={STEPS}, log_every=1, verbose=False)
import contextlib, io
from repro.resilience import ChaosConfig, ResilienceConfig
log = io.StringIO()
with contextlib.redirect_stdout(log):
    replan = trainer.train(arch, RunConfig(**{REPLAN_RUN}), mesh,
                           steps={REPLAN_STEPS}, log_every=1, verbose=True)
with open(sys.argv[1], "wb") as f:
    pickle.dump({{"params": tree, "caps": ctx.plan.caps, "x": x, "r": r,
                 "y": np.asarray(y),
                 "metrics": {{k: np.asarray(v) for k, v in m.items()}},
                 "grads": jax.tree_util.tree_map(np.asarray, g),
                 "history": res.metrics_history,
                 "final": jax.tree_util.tree_map(np.asarray, res.params),
                 "micro_history": micro.metrics_history,
                 "micro_final": jax.tree_util.tree_map(np.asarray,
                                                       micro.params),
                 "replan_history": replan.metrics_history,
                 "replans": replan.replans, "replan_log": log.getvalue()}},
                f)
"""


def _rank_main(world, ref_path, out_dir):
    """One rank of the port's world: the engine case and the trainer, with
    the kernels wanted and not; its results go to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    arch = get_config(ARCH_ID).reduced()
    per = BATCH // world.size
    rows = slice(world.rank * per, (world.rank + 1) * per)
    out = {"rank": world.rank, "coords": world.coords}
    for use_pallas in (False, True):
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              aux_mode="ta", use_pallas=use_pallas,
                              device="cpu")
        params = params_from_numpy(ref["params"], ctx, "cpu")
        p = {k: (v.requires_grad_(True) if torch.is_tensor(v)
                 else {kk: vv.requires_grad_(True) for kk, vv in v.items()})
             for k, v in params["layers"][1]["ffn"].items()}
        x = torch.from_numpy(ref["x"][rows].copy()).requires_grad_(True)
        y, m = transformer._moe_block(p, x, ctx, decode=False, layer_idx=1)
        # this rank's part of the global sum(y * r) + pmean(aux): the aux
        # loss keeps this rank's own gradient (see transformer._world_mean)
        (torch.sum(y * torch.from_numpy(ref["r"][rows].copy()))
         + m["aux_loss"] / world.size).backward()
        gate = world.all_reduce_sum(p["gate"]["w"].grad)
        res = trainer.train(
            arch, RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                            aux_mode="ta", dispatch="a2a", seed=0,
                            use_pallas=use_pallas),
            world, steps=STEPS, log_every=1, verbose=False,
            params=params_from_numpy(ref["params"], ctx, "cpu"),
            device="cpu")
        out[use_pallas] = {
            "caps": ctx.plan.caps, "expert_range": ctx.expert_range,
            "y": y.detach().numpy(),
            "metrics": {k: v.detach().numpy() for k, v in m.items()},
            "gx": x.grad.numpy(), "g_gate": gate.numpy(),
            "g_w_in": p["w_in"].grad.numpy(),
            "g_w_out": p["w_out"].grad.numpy(),
            "history": res.metrics_history,
            "final": [t.detach().numpy() for t in
                      _leaves(res.params)]}
    from repro_torch.core import comm_model
    mctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                           dispatch="a2a_pipelined", measured_comm=True,
                           device="cpu")
    links = comm_model.measured_ep_links(world, mctx.ep.axis_names)
    out["measured"] = {
        "chunks": mctx.a2a_num_chunks,
        "want_chunks": model.resolve_num_chunks(
            arch, model.make_plan(arch, world, SEQ, BATCH, "ta"),
            links=links),
        "links": {ax: (li.alpha, li.beta, li.nbytes, li.times)
                  for ax, li in links.items()}}
    out["moe_links"] = {
        k: (li.alpha, li.beta, li.nbytes, li.times) for k, li in
        comm_model.measured_moe_links(world, data_axis="data",
                                      pod_axis="pod").items()}
    micro = trainer.train(
        arch, RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                        aux_mode="ta", dispatch="a2a", seed=0,
                        microbatch=MICRO),
        world, steps=STEPS, log_every=1, verbose=False,
        params=params_from_numpy(ref["params"], ctx, "cpu"), device="cpu")
    out["micro_history"] = micro.metrics_history
    out["micro_final"] = [t.detach().numpy() for t in _leaves(micro.params)]
    import contextlib
    import io

    # REPLAN_RUN names ChaosConfig and ResilienceConfig: the same text
    # builds the reference's run in its subprocess
    from repro_torch.resilience import ChaosConfig, ResilienceConfig  # noqa: F401
    run = RunConfig(use_pallas=True, **eval(REPLAN_RUN))
    rctx = model.build_ctx(arch, world, seq_len=run.seq_len,
                           global_batch=run.global_batch, device="cpu")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        replan = trainer.train(
            arch, run, world, steps=REPLAN_STEPS, log_every=1, verbose=True,
            params=params_from_numpy(ref["params"], rctx, "cpu"),
            device="cpu")
    out["replan"] = {"history": replan.metrics_history,
                     "replans": replan.replans, "log": log.getvalue(),
                     "caps_before": rctx.plan.caps}
    with open(os.path.join(out_dir, f"rank{world.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _leaves(tree):
    from repro_torch.optim import adamw
    return adamw.tree_leaves(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0..3 results]) — one JAX subprocess, then
    one 4-process gloo world of the port."""
    from repro_torch.launch import mesh
    tmp = tmp_path_factory.mktemp("world22")
    ref_path = str(tmp / "reference.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE)
                        .replace("{REPLAN_RUN}", REPLAN_RUN), ref_path],
                       capture_output=True, text=True,
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


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_world_layout_and_plan(runs):
    """Rank r sits at row-major (pod, data) coordinates, holds experts
    r*E_l:(r+1)*E_l, and plans the reference's capacities."""
    ref, ranks = runs
    for r, out in enumerate(ranks):
        assert out["rank"] == r
        assert out["coords"] == divmod(r, SIZES[1])
        for use_pallas in (False, True):
            assert out[use_pallas]["caps"] == ref["caps"]
            assert out[use_pallas]["expert_range"] == (r, r + 1)
    assert len(ref["caps"]) == 2 and min(ref["caps"]) > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_a2a_engine_outputs_and_metrics_match_reference(runs, use_pallas):
    ref, ranks = runs
    y = np.concatenate([out[use_pallas]["y"] for out in ranks])
    close(y, ref["y"])
    for out in ranks:                     # world means: equal on every rank
        assert set(out[use_pallas]["metrics"]) == set(METRIC_KEYS)
        for k in METRIC_KEYS:
            close(out[use_pallas]["metrics"][k], ref["metrics"][k])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_a2a_engine_grads_match_reference(runs, use_pallas):
    ref, ranks = runs
    g = ref["grads"]
    close(np.concatenate([out[use_pallas]["gx"] for out in ranks]), g[1])
    for out in ranks:
        close(out[use_pallas]["g_gate"], g[0]["gate"]["w"])
    for k in ("w_in", "w_out"):
        close(np.concatenate([out[use_pallas][f"g_{k}"] for out in ranks]),
              g[0][k])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainer_steps_match_reference(runs, use_pallas):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.launch.mesh import EPWorld
    ref, ranks = runs
    for out in ranks:
        hist = out[use_pallas]["history"]
        assert len(hist) == len(ref["history"]) == STEPS
        for got, want in zip(hist, ref["history"]):
            for k in HISTORY_KEYS:
                close(got[k], want[k])
    arch = get_config(ARCH_ID).reduced()
    for out in ranks:
        world = EPWorld(axis_names=("pod", "data"), axis_sizes=SIZES,
                        coords=out["coords"])
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              device="cpu")
        want = _leaves(params_from_numpy(ref["final"], ctx, "cpu"))
        assert len(want) == len(out[use_pallas]["final"])
        for a, b in zip(out[use_pallas]["final"], want):
            close(a, b, rtol=1e-4, atol=2e-4)


def test_microbatch_accumulation_matches_reference(runs):
    """Accumulation over 2 microbatches of 4 rows on the world: each rank
    takes its row of each microbatch (``shard_batch(microbatch=)``), its
    backward runs each microbatch's chains, the gradient sync runs once;
    the reference's ``_accum_step`` on the 2x2 mesh gives the same steps
    (metrics 1e-4, final params atol 2e-4)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    ref, ranks = runs
    for out in ranks:
        for got, want in zip(out["micro_history"], ref["micro_history"]):
            for k in HISTORY_KEYS:
                close(got[k], want[k])
    arch = get_config(ARCH_ID).reduced()
    for out in ranks:
        world = EPWorld(axis_names=("pod", "data"), axis_sizes=SIZES,
                        coords=out["coords"])
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              device="cpu")
        want = _leaves(params_from_numpy(ref["micro_final"], ctx, "cpu"))
        for a, b in zip(out["micro_final"], want):
            close(a, b, rtol=1e-4, atol=2e-4)


def test_degraded_link_replan_matches_reference(runs):
    """The port's resilient runtime on the world, kernel branches wanted:
    at the step-4 probe the measured links (gloo all-to-alls, timed once
    and cached) with the pod axis degraded 64x make every rank replan
    once, to the reference's caps (64, 0): the pod stage is gone, stage 0
    carries every remote token.  Every logged step, before and after the
    replan, agrees with the reference's at 1e-4 on every rank."""
    ref, ranks = runs
    assert ref["replans"] == 1
    assert "replan: caps -> (64, 0)" in ref["replan_log"]
    for out in ranks:
        rp = out["replan"]
        assert rp["replans"] == 1
        assert rp["caps_before"] != (64, 0)
        assert "step     4 replan: caps -> (64, 0)" in rp["log"]
        assert rp["history"][-1]["replans"] == 1
        assert len(rp["history"]) == len(ref["replan_history"])
        for got, want in zip(rp["history"], ref["replan_history"]):
            for k in HISTORY_KEYS:
                close(got[k], want[k])


def test_train_launcher_spawns_a_world(capfd):
    """``launch/train.py --devices 4 --mesh-shape 2,2,1`` on the CPU: four
    gloo ranks, accumulation and remat on, rank 0 reports."""
    from repro_torch.launch import train
    assert train.main(["--arch", ARCH_ID, "--reduced", "--device", "cpu",
                       "--devices", "4", "--mesh-shape", "2,2,1",
                       "--steps", "2", "--seq-len", "16",
                       "--global-batch", "8", "--microbatch", "4",
                       "--remat", "--log-every", "1"]) == 0
    out = capfd.readouterr().out
    assert "done: 2 steps on 4 rank(s)" in out


def test_measured_links_agree_across_ranks(runs):
    """``build_ctx(measured_comm=True)`` on the world: every rank times
    the gloo all-to-all over each axis at the reference's sizes and fits
    the world mean of the readings, so all ranks hold the same links and
    pick the same chunk count (the overlap model's verdict on those
    links); later probes read the cache."""
    _, ranks = runs
    first = ranks[0]["measured"]
    assert set(first["links"]) == {"pod", "data"}
    for ax, (alpha, beta, nbytes, times) in first["links"].items():
        assert alpha >= 0.0 and beta >= 1e-15
        assert nbytes == (8192, 65536, 524288) and len(times) == 3
        assert all(t > 0 for t in times)
    for out in ranks:
        assert out["measured"] == first
        assert out["measured"]["chunks"] == out["measured"]["want_chunks"]


def test_measured_moe_links_name_the_per_axis_probes(runs):
    """``measured_moe_links`` (the reference's 2-level wrapper) gives the
    data axis's link as ``near`` and the pod axis's as ``far``, read from
    the same per-axis cache as ``measured_ep_links``."""
    _, ranks = runs
    for out in ranks:
        links = out["measured"]["links"]
        assert out["moe_links"] == {"near": links["data"],
                                    "far": links["pod"]}
