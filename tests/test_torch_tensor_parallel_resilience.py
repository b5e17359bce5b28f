"""Checkpoints, the guarded step and the replan on a (data 2, model 2)
world of the port against the JAX package's trainer on a (data 2, model
2) mesh of forced host devices.

One JAX subprocess on 4 forced host devices runs reduced
``gpt3_medium_moe`` (4 experts, EP 2 over ``data``, each expert's width
over ``model``) through ``trainer.train`` three times:

- 4 plain steps (the uninterrupted run);
- a chaos run of 9 guarded steps with rolling checkpoints every 2 steps:
  a NaN gradient at step 2 (skipped), the weights wrecked after step 6
  (a spike rolled back at step 8), the checkpoint of step 5 corrupted on
  its way to disk, so the rollback passes it;
- 8 guarded steps with the ``data`` link degraded 8x from step 2, which
  the probe at step 4 sees: the replan shrinks the ``data`` level's
  share of the one stage's capacity (32 -> 8).

Beside it (``torch_world_reference``), 4 CPU processes of the port,
joined over gloo (``launch.mesh.spawn(..., model=2)``), run the same
from the same weights, and besides:

- save the state after 2 steps (one payload a process, ``ckpt.rank_path``
  at the process rank), restore it into fresh tensors and take the last
  2 steps from there;
- run the chaos with the NaN gradient planted on model coordinate 1
  only: the verdict is agreed over the model axis, so both model ranks
  of each data rank skip that step;
- time their links for the pipelined dispatch's chunk count
  (``build_ctx(measured_comm=True)``), each model coordinate's EP group
  timing its own all-to-alls.

Tolerance: rtol = atol = 1e-4 against the reference (float32); bit for
bit between the port's own runs and between its model ranks.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH_ID = "gpt3_medium_moe"
SIZES, MODEL = (2,), 2
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS, CUT = 4, 2
PLAIN_RUN = ("dict(seq_len=16, global_batch=4, warmup_steps=1, "
             "aux_mode='ta', seed=0)")
CHAOS_STEPS, WRECK = 9, 6
CHAOS_RUN = ("dict(seq_len=16, global_batch=4, warmup_steps=2, "
             "aux_mode='ta', seed=0, resilience=ResilienceConfig("
             "rollback_on_spike=True, spike_factor=1.5, spike_patience=2, "
             "spike_warmup=3, chaos=ChaosConfig(nan_grad_steps=(2,), "
             "spike_steps=(6,), corrupt_ckpt_steps=(5,))))")
REPLAN_STEPS = 8
REPLAN_RUN = ("dict(seq_len=16, global_batch=4, total_steps=8, "
              "warmup_steps=2, aux_mode='ta', seed=0, "
              "resilience=ResilienceConfig(replan_every=4, "
              "degrade_threshold=4.0, collapse_slowdown=64.0, "
              "chaos=ChaosConfig(degraded_links=((2, 'data', 8.0),))))")
HISTORY_KEYS = ("loss", "nll", "aux", "grad_norm", "lr", "skipped_steps",
                "rollbacks", "replans")

REFERENCE = f"""
import contextlib, io, pickle, sys, tempfile
import jax, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import RunConfig, get_config
from repro.models import model
from repro.resilience import ChaosConfig, ResilienceConfig
from repro.training import trainer

mesh = make_mesh({SIZES + (MODEL,)}, ("data", "model"))
rules = model.default_rules(mesh)
arch = get_config("{ARCH_ID}").reduced()
plain = RunConfig(**{PLAIN_RUN})
ctx = model.build_ctx(arch, mesh, seq_len=plain.seq_len,
                      global_batch=plain.global_batch, aux_mode="ta")
with mesh, sharding.axis_rules(rules):
    params = model.init_params(jax.random.PRNGKey(plain.seed), ctx,
                               rules=rules)
dump_inputs({{"params": jax.tree_util.tree_map(np.asarray, params)}})
out = {{}}
res = trainer.train(arch, plain, mesh, steps={STEPS}, log_every=1,
                    verbose=False)
out["plain"] = res.metrics_history
out["plain_final"] = jax.tree_util.tree_map(np.asarray, res.params)
tmp = tempfile.mkdtemp()
res = trainer.train(arch, RunConfig(**{CHAOS_RUN}), mesh,
                    steps={CHAOS_STEPS}, log_every=1, verbose=False,
                    ckpt_path=tmp + "/ck.npz", ckpt_every=2)
out["chaos"] = res.metrics_history
out["chaos_counts"] = (res.skipped_steps, res.rollbacks)
out["chaos_final"] = jax.tree_util.tree_map(np.asarray, res.params)
log = io.StringIO()
with contextlib.redirect_stdout(log):
    res = trainer.train(arch, RunConfig(**{REPLAN_RUN}), mesh,
                        steps={REPLAN_STEPS}, log_every=1, verbose=True)
out["replan"] = res.metrics_history
out["replans"] = res.replans
out["replan_log"] = log.getvalue()
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _history(hist):
    return [{k: h[k] for k in HISTORY_KEYS if k in h} for h in hist]


def _leaves(tree):
    from repro_torch.optim import adamw
    return adamw.tree_leaves(tree)


def _rank_main(world, ref_path, out_dir):
    torch.set_num_threads(1)
    import contextlib
    import io

    from repro_torch import sharding
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.core import comm_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.resilience import ChaosConfig, ResilienceConfig  # noqa: F401
    from repro_torch.resilience import chaos as chaos_lib
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    arch = get_config(ARCH_ID).reduced()
    out = {"rank": world.rank, "model_coord": world.model_coord}
    plain = RunConfig(**eval(PLAIN_RUN))
    ctx = model.build_ctx(arch, world, seq_len=plain.seq_len,
                          global_batch=plain.global_batch, aux_mode="ta",
                          device="cpu")

    def fresh():
        return params_from_numpy(ref["params"], ctx, "cpu")

    # the uninterrupted run, then the run cut after CUT steps and resumed
    # from its checkpoint
    full = trainer.train(arch, plain, world, steps=STEPS, log_every=1,
                         verbose=False, params=fresh(), device="cpu")
    out["plain"] = _history(full.metrics_history)
    path = os.path.join(out_dir, "cut.npz")
    cut = trainer.train(arch, plain, world, steps=CUT, log_every=1,
                        verbose=False, params=fresh(), device="cpu",
                        ckpt_path=path)
    mine = ckpt.rank_path(path, world.process_rank,
                          world.size * world.model)
    out["payload"] = os.path.basename(mine)
    out["verified"] = ckpt.verify(mine)
    params = fresh()
    for p in _leaves(params):
        p.requires_grad_(True)
    state = ckpt.restore_into(mine, {"params": params,
                                     "opt": adamw.init_state(params)})
    out["restored_equal"] = all(
        torch.equal(a.detach(), b.detach()) for a, b in zip(
            _leaves(state["params"]) + _leaves(state["opt"]["mu"])
            + _leaves(state["opt"]["nu"]),
            _leaves(cut.params) + _leaves(cut.opt_state["mu"])
            + _leaves(cut.opt_state["nu"])))
    out["restored_step"] = state["opt"]["step"]
    sliced = [sharding.model_dim(s) is not None for s in
              trainer.model_specs(state["params"], ctx)].index(True)
    out["sliced_leaf"] = _leaves(state["params"])[sliced].detach().numpy()
    step = trainer.make_train_step(ctx, plain)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=plain.seq_len,
                                  global_batch=plain.global_batch,
                                  seed=plain.seed), arch)
    params, opt = state["params"], state["opt"]
    resumed = []
    for i in range(CUT, STEPS):
        params, opt, m = step(params, opt,
                              shard_batch(data.batch(i), world, "cpu"))
        resumed.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    out["resumed"] = resumed
    out["resumed_final_equal"] = all(
        torch.equal(a.detach(), b.detach())
        for a, b in zip(_leaves(params), _leaves(full.params)))

    # the chaos run, its NaN gradient planted on model coordinate 1 only
    orig = chaos_lib.fault_scales

    def planted(cfg, i):
        scales = dict(orig(cfg, i))
        if world.model_coord == 0:
            scales["grad_mult"] = 1.0
        return scales

    chaos_lib.fault_scales = planted
    try:
        res = trainer.train(
            arch, RunConfig(**eval(CHAOS_RUN)), world, steps=CHAOS_STEPS,
            log_every=1, verbose=False, params=fresh(), device="cpu",
            ckpt_path=os.path.join(out_dir, f"chaos{world.process_rank}",
                                   "ck.npz"), ckpt_every=2)
    finally:
        chaos_lib.fault_scales = orig
    out["chaos"] = _history(res.metrics_history)
    out["chaos_counts"] = (res.skipped_steps, res.rollbacks)
    out["chaos_final"] = [t.detach().numpy()
                          for t in _leaves(model.gather_params(res.params,
                                                               ctx))]

    # the degraded-link replan
    run = RunConfig(**eval(REPLAN_RUN))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = trainer.train(arch, run, world, steps=REPLAN_STEPS,
                            log_every=1, verbose=True, params=fresh(),
                            device="cpu")
    out["replan"] = _history(res.metrics_history)
    out["replans"] = res.replans
    out["replan_log"] = log.getvalue()

    # measured links and the chunk count they pick
    mctx = model.build_ctx(arch, world, seq_len=plain.seq_len,
                           global_batch=plain.global_batch, aux_mode="ta",
                           dispatch="a2a_pipelined", measured_comm=True,
                           device="cpu")
    link = comm_model.measure_link(world, "data")
    out["links"] = (link.alpha, link.beta, link.times)
    out["chunks"] = (mctx.a2a_num_chunks, mctx.plan.caps)
    with open(os.path.join(out_dir, f"rank{world.process_rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [process 0..3 results]) — one JAX subprocess
    and, beside it once it has made the weights, one 4-process (data 2,
    model 2) gloo world of the port."""
    from repro_torch.launch import mesh
    from torch_world_reference import run_beside_world
    tmp = tmp_path_factory.mktemp("tensor_parallel_resilience")
    ref = run_beside_world(
        REFERENCE, 4, tmp,
        lambda inputs: mesh.spawn(_rank_main, SIZES, "gloo", "cpu",
                                  args=(inputs, str(tmp)), model=MODEL))
    ranks = []
    for i in range(4):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _same_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in g:
            close(g[k], w[k])


def test_checkpoint_round_trip_on_a_model_axis(runs):
    """Each of the four processes writes its own payload (``.rank<p>``),
    which verifies; restored into fresh tensors it gives the saved
    parameters and AdamW moments bit for bit, at the saved step; the two
    model ranks' payloads hold different slices of a split leaf."""
    _, ranks = runs
    assert [r["payload"] for r in ranks] == [f"cut.rank{p}.npz"
                                             for p in range(4)]
    for r in ranks:
        assert r["verified"] and r["restored_equal"]
        assert r["restored_step"] == CUT
    assert not np.array_equal(ranks[0]["sliced_leaf"],
                              ranks[1]["sliced_leaf"])


def test_restored_run_continues_as_uninterrupted(runs):
    """From the checkpoint of step 2, the last two steps give the
    uninterrupted run's loss and gradient norm and its final weights, bit
    for bit; the uninterrupted run is the reference's at 1e-4."""
    ref, ranks = runs
    want = _history(ref["plain"])
    for r in ranks:
        _same_history(r["plain"], want)
        for got, full in zip(r["resumed"], r["plain"][CUT:]):
            assert got["loss"] == full["loss"]
            assert got["grad_norm"] == full["grad_norm"]
        assert r["resumed_final_equal"]


def test_guarded_run_with_a_fault_on_one_model_rank(runs):
    """The chaos run with its NaN gradient on model coordinate 1 only:
    every rank skips step 2 (the verdict agreed over the model axis),
    rolls back once past the corrupted checkpoint, and logs the
    reference's counters at every step and its metrics up to the wreck
    of step 6 (the two steps on the wrecked weights, whose near-tied
    routing the two packages' float32 sums decide apart, by their
    counters); the final weights, restored from step 3's checkpoint and
    gathered over the model axis, are the same bits on both model ranks
    and the reference's at 1e-4."""
    from repro_torch.optim import adamw
    from test_torch_tensor_parallel import _ref_tree
    ref, ranks = runs
    assert ref["chaos_counts"] == (1, 1)
    want = _history(ref["chaos"])
    final = adamw.tree_leaves(_ref_tree("gpt3", ref["chaos_final"]))
    counters = ("skipped_steps", "rollbacks", "replans")
    for r in ranks:
        assert r["chaos_counts"] == (1, 1)
        _same_history(r["chaos"][:WRECK + 1], want[:WRECK + 1])
        assert [{k: h[k] for k in counters} for h in r["chaos"]] == \
            [{k: h[k] for k in counters} for h in want]
    for a, b in zip(ranks[0::2], ranks[1::2]):
        for x, y in zip(a["chaos_final"], b["chaos_final"]):
            assert np.array_equal(x, y)
    # expert leaves hold the rank's EP shard: compare the replicated ones
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.training import trainer
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), seq_len=16,
                          global_batch=4, device="cpu")
    tree = _ref_tree("gpt3", ref["chaos_final"])
    for got, w, e in zip(ranks[0]["chaos_final"], final,
                         trainer.expert_mask(tree, ctx)):
        if not e:
            close(got, w.numpy())


def test_degraded_link_replan_on_a_model_axis(runs):
    """The ``data`` link degraded 8x from step 2: at the probe of step 4
    every one of the four processes replans to the reference's caps (the
    ``data`` level's ratio shrunk by the slowdown: 32 -> 8 slots), and
    the steps before and after are the reference's at 1e-4."""
    ref, ranks = runs
    assert ref["replans"] == 1
    line = [ln for ln in ref["replan_log"].splitlines() if "replan" in ln]
    assert len(line) == 1 and line[0].endswith("(8,)")
    caps = line[0].split("caps -> ")[1]
    want = _history(ref["replan"])
    for r in ranks:
        assert r["replans"] == 1
        assert f"step     4 replan: caps -> {caps}" in r["replan_log"]
        _same_history(r["replan"], want)


def test_measured_links_agree_over_the_model_axis(runs):
    """Each model coordinate's EP group times its own all-to-alls, and
    the fit is the mean over all four processes: the same link estimate,
    chunk count and plan on every process."""
    _, ranks = runs
    for r in ranks[1:]:
        assert r["links"] == ranks[0]["links"]
        assert r["chunks"] == ranks[0]["chunks"]
    assert ranks[0]["chunks"][0] >= 1


def test_a_collapsed_plan_drops_every_pick():
    """A replan past ``collapse_slowdown`` on a one-axis EP world drives
    the only stage's capacity to 0 (the single stage carries the self
    and the ``data`` level alike): the staged path then routes nothing,
    as the reference's does: a zero output and ``dropped`` 1.0 (the
    reference's ``1 - clip(0 / (T * k), 1)``), where the port used to
    fail summing no selections.  One rank of the (data 2) world,
    emulated by a ``RecordingWorld``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.dispatch import engine as dispatch_lib
    from repro_torch.launch import mesh
    from repro_torch.models import model
    from repro_torch.resilience import ResilienceConfig
    from repro_torch.resilience.policy import RecoveryPolicy
    arch = get_config(ARCH_ID).reduced()
    world = mesh.recording_world((2,))
    ctx = model.build_ctx(arch, world, seq_len=16, global_batch=4,
                          device="cpu")
    new = RecoveryPolicy(ResilienceConfig(replan_every=4)).replan(
        ctx, {"data": 100.0})
    assert ctx.plan.caps == (32,) and new.plan.caps == (0,)
    params = model.init_params(new, torch.Generator().manual_seed(0), "cpu")
    eng = dispatch_lib.make_engine(
        "a2a", cfg=new.moe_cfg, ep=new.ep, gate_cfg=new.gate_cfg,
        plan=new.plan, num_chunks=1, tokens_replicated=False,
        use_pallas=None, world=world)
    x = torch.randn((32, arch.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y, m = eng(params["layers"][0]["ffn"], x)
    assert torch.equal(y, torch.zeros_like(y))
    assert float(m["dropped"]) == 1.0
    assert not world.log        # no stage: no all-to-all
