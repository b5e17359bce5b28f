"""The port's resilient training runtime (``repro_torch.resilience`` and
the guarded ``trainer.train``), case for case with
``tests/test_resilience.py``: the guard, chaos and policy units, and the
chaos scenarios end to end at ``gpt3_medium_moe.reduced()`` (float32) on
one rank.  The guarded run with no chaos must give the unguarded run's
parameters bit for bit, and a rollback must restore the checkpointed
tensors bit for bit.  PyTorch's CPU kernels sum in a thread-dependent
order, so the runs compared bit for bit use one thread (``one_thread``).
Where the reference's run is recomputed (no chaos, and a NaN skip), the
port's logged metrics agree with it at rtol = atol = 1e-4.
"""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_config as jax_get_config
from repro.models import model as jmodel
from repro.resilience import ChaosConfig as JChaosConfig
from repro.resilience import ResilienceConfig as JResilienceConfig
from repro.training import trainer as jtrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig, get_config
from repro_torch.models import model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.resilience import ChaosConfig, RecoveryPolicy, ResilienceConfig
from repro_torch.resilience import chaos as chaos_lib
from repro_torch.resilience import guards
from repro_torch.training import trainer

ARCH_ID = "gpt3_medium_moe"


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_cfg(**kw):
    base = dict(seq_len=32, global_batch=4, total_steps=10, warmup_steps=2,
                aux_mode="ta", seed=0)
    base.update(kw)
    return RunConfig(**base)


def _train(run, steps, **kw):
    arch = get_config(ARCH_ID).reduced()
    return trainer.train(arch, run, steps=steps, log_every=1, verbose=False,
                         device="cpu", **kw)


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x.detach(), y.detach()) for x, y in
               zip(adamw.tree_leaves(a), adamw.tree_leaves(b)))


# ---------------------------------------------------------------------------
# guards (pure units, no model)
# ---------------------------------------------------------------------------


def test_nonfinite_score_flags_any_poisoned_leaf():
    grads = {"a": torch.ones(3), "b": torch.zeros((2, 2))}
    one = torch.tensor(1.0)
    assert bool(torch.isfinite(guards.nonfinite_score(one, grads)))
    for poison in (math.nan, math.inf, -math.inf):
        a = torch.ones(3)
        a[1] = poison
        score = guards.nonfinite_score(one, {"a": a, "b": grads["b"]})
        assert not bool(torch.isfinite(score))
    score = guards.nonfinite_score(torch.tensor(math.nan), grads)
    assert not bool(torch.isfinite(score))


def test_spike_detector_warmup_patience_and_baseline_protection():
    det = guards.SpikeDetector(factor=2.0, patience=2, beta=0.5, warmup=2)
    assert not det.update(1.0) and not det.update(1.0)   # warmup absorbs
    ema_before = det.ema
    assert not det.update(10.0)       # spike 1/2: streak, EMA untouched
    assert det.ema == ema_before
    assert det.update(10.0)           # spike 2/2: sustained -> trip
    det.reset()
    assert det.streak == 0 and det.ema == ema_before
    assert not det.update(math.nan)
    early = guards.SpikeDetector(factor=2.0, patience=1, beta=0.5, warmup=3)
    early.update(1.0)
    early.update(1.0)
    assert not early.update(50.0)     # n=2 < warmup=3


def test_drop_watermark_rearm_and_disable():
    wm = guards.DropWatermark(watermark=0.5, patience=2)
    assert not wm.update(0.6)
    assert wm.update(0.6)
    assert not wm.update(0.6)         # re-armed: streak restarts
    assert guards.DropWatermark(watermark=1.0).update(0.99) is False
    assert guards.DropWatermark(watermark=0.5).update(None) is False


def test_chaos_schedules_are_pure_and_deterministic():
    cfg = ChaosConfig(seed=7, nan_grad_steps=(3,), nan_loss_steps=(4,),
                      spike_steps=(5,), degraded_links=((2, "pod", 8.0),
                                                        (6, "pod", 2.0)))
    healthy = chaos_lib.fault_scales(cfg, 0)
    assert healthy == {"loss_mult": 1.0, "grad_mult": 1.0, "param_scale": 1.0}
    assert math.isnan(chaos_lib.fault_scales(cfg, 3)["grad_mult"])
    assert math.isnan(chaos_lib.fault_scales(cfg, 4)["loss_mult"])
    assert chaos_lib.fault_scales(cfg, 5)["param_scale"] == cfg.spike_scale
    assert chaos_lib.link_multipliers(cfg, 1) == {}
    assert chaos_lib.link_multipliers(cfg, 2) == {"pod": 8.0}
    assert chaos_lib.link_multipliers(cfg, 6) == {"pod": 16.0}
    assert chaos_lib.fault_scales(None, 3)["grad_mult"] == 1.0


def test_corrupt_checkpoint_is_seeded_as_the_reference(tmp_path):
    """Same seed, same flips; and the same flips as the reference's."""
    from repro.resilience import chaos as jchaos
    payload = bytes(range(256)) * 8
    outs = []
    for name, fn in (("a", chaos_lib.corrupt_checkpoint),
                     ("b", chaos_lib.corrupt_checkpoint),
                     ("ref", jchaos.corrupt_checkpoint)):
        p = str(tmp_path / f"{name}.bin")
        with open(p, "wb") as f:
            f.write(payload)
        fn(p, seed=3)
        with open(p, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] == outs[2] != payload


# ---------------------------------------------------------------------------
# policy units
# ---------------------------------------------------------------------------


def test_policy_classify_precedence_and_counters():
    pol = RecoveryPolicy(ResilienceConfig(rollback_on_spike=True,
                                          spike_factor=2.0, spike_patience=1,
                                          spike_warmup=0))
    assert pol.classify(0, {"nonfinite": 0.0, "loss": 1.0}) == "ok"
    assert pol.classify(1, {"nonfinite": 1.0, "loss": 1.0}) == "skip"
    assert pol.classify(2, {"nonfinite": 0.0, "loss": math.nan}) == "skip"
    assert pol.healthy
    assert pol.classify(3, {"nonfinite": 0.0, "loss": 50.0}) == "rollback"
    pol.on_rollback()
    assert pol.healthy
    assert pol.counters() == {"skipped_steps": 2, "rollbacks": 1,
                              "replans": 0, "drop_alarms": 0}


def test_policy_drop_alarm_counts_without_acting():
    pol = RecoveryPolicy(ResilienceConfig(drop_watermark=0.2,
                                          drop_patience=2))
    acts = [pol.classify(i, {"nonfinite": 0.0, "loss": 1.0, "dropped": 0.5})
            for i in range(4)]
    assert acts == ["ok"] * 4 and pol.drop_alarms == 2


def test_replan_collapses_the_degraded_level_like_the_reference():
    """``replan`` on the 2x2 plan of the reference's degraded-link test
    (seq 32, global batch 4): a pod slowdown of 64 collapses the pod
    level to the reference planner's caps with that level's beta scaled
    to inf; a repeat of the same slowdowns replans nothing; a slowdown of
    8 moves no capacity at this size."""
    from repro.core import capacity as jcapacity
    from repro.core import topology as jtopology
    from repro_torch.launch.mesh import EPWorld
    arch = get_config(ARCH_ID).reduced()
    world = EPWorld(axis_names=("pod", "data"), axis_sizes=(2, 2),
                    coords=(0, 0), device="cpu")
    ctx = model.build_ctx(arch, world, seq_len=32, global_batch=4,
                          aux_mode="ta", device="cpu")
    cfg = ResilienceConfig(replan_every=2, degrade_threshold=4.0,
                           collapse_slowdown=64.0)
    pol = RecoveryPolicy(cfg)
    new = pol.replan(ctx, {"pod": 64.0, "data": 1.0})
    assert new.plan.caps == (64, 0) and pol.replans == 1
    assert pol.replan(new, {"pod": 64.0, "data": 1.0}) is None
    want = jcapacity.make_dispatch_plan(
        tokens_per_device=ctx.plan.tokens_per_device,
        num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor, axis_sizes=(2, 2),
        axis_names=("pod", "data"), mode="ta",
        comm=jtopology.tree_topology_nd((2, 2)),
        level_beta_scale=(1.0, 1.0, math.inf))
    assert new.plan.caps == want.caps
    assert new.plan.ratios == pytest.approx(want.ratios)
    assert new.gate_cfg.penalty_by_level == pytest.approx(
        model.make_gate_cfg(arch, new.plan, ctx.ep, "ta").penalty_by_level)
    # a slowdown of 8 leaves the reference planner's caps as they were
    # at this size, so nothing is replanned
    same = jcapacity.make_dispatch_plan(
        tokens_per_device=ctx.plan.tokens_per_device,
        num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor, axis_sizes=(2, 2),
        axis_names=("pod", "data"), mode="ta",
        comm=jtopology.tree_topology_nd((2, 2)),
        level_beta_scale=(1.0, 1.0, 8.0))
    assert same.caps == ctx.plan.caps
    assert RecoveryPolicy(cfg).replan(ctx, {"pod": 8.0}) is None


# ---------------------------------------------------------------------------
# guarded training loop (chaos scenarios end to end)
# ---------------------------------------------------------------------------


def test_guards_on_no_chaos_is_bit_identical(one_thread):
    plain = _train(_run_cfg(), steps=4)
    guarded = _train(_run_cfg(resilience=ResilienceConfig()), steps=4)
    assert _equal_trees(plain.params, guarded.params)
    assert _equal_trees(plain.opt_state["mu"], guarded.opt_state["mu"])
    assert plain.losses == guarded.losses
    assert guarded.skipped_steps == 0 and guarded.rollbacks == 0
    assert guarded.metrics_history[-1]["skipped_steps"] == 0
    assert plain.metrics_history[-1]["skipped_steps"] == 0
    assert all(h["nonfinite"] == 0.0 for h in guarded.metrics_history)


@pytest.fixture(scope="module")
def reference_nan_run():
    """The reference's guarded run with a NaN-grad and a NaN-loss step,
    and its initial parameters."""
    from repro import sharding
    from repro.compat import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    jarch = jax_get_config(ARCH_ID).reduced()
    res = JResilienceConfig(chaos=JChaosConfig(nan_grad_steps=(2,),
                                               nan_loss_steps=(4,)))
    kw = dict(seq_len=32, global_batch=4, total_steps=10, warmup_steps=2,
              aux_mode="ta", seed=0)
    r = jtrainer.train(jarch, JRunConfig(resilience=res, **kw), mesh,
                       steps=7, log_every=1, verbose=False)
    jctx = jmodel.build_ctx(jarch, mesh, seq_len=32, global_batch=4,
                            aux_mode="ta")
    rules = jmodel.default_rules(mesh)
    with mesh, sharding.axis_rules(rules):
        p0 = jmodel.init_params(jax.random.PRNGKey(0), jctx, rules=rules)
    return r, jax.tree_util.tree_map(np.asarray, p0)


def test_nan_grad_step_is_skipped_and_run_survives(reference_nan_run):
    want, p0 = reference_nan_run
    res = ResilienceConfig(chaos=ChaosConfig(nan_grad_steps=(2,),
                                             nan_loss_steps=(4,)))
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), seq_len=32,
                          global_batch=4, device="cpu")
    r = _train(_run_cfg(resilience=res), steps=7,
               params=params_from_numpy(p0, ctx, "cpu"))
    assert r.skipped_steps == want.skipped_steps == 2
    assert math.isfinite(r.losses[-1])
    for leaf in adamw.tree_leaves(r.params):
        assert bool(torch.all(torch.isfinite(leaf)))
    assert r.metrics_history[-1]["skipped_steps"] == 2
    assert r.opt_state["step"] == 5   # two of seven updates skipped
    for got, ref in zip(r.metrics_history, want.metrics_history):
        assert got["nonfinite"] == ref["nonfinite"]
        for k in ("loss", "nll", "aux"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4)


def test_spike_rollback_restores_exact_pre_spike_params(tmp_path):
    """Param corruption at step 6 spikes the loss; patience-2 detection
    rolls back at step 8, the final step, so the returned params and
    moments must be the step-5 rolling checkpoint bit for bit."""
    ck = str(tmp_path / "ck.npz")
    res = ResilienceConfig(rollback_on_spike=True, spike_factor=1.5,
                           spike_patience=2, spike_warmup=3,
                           chaos=ChaosConfig(spike_steps=(6,)))
    r = _train(_run_cfg(resilience=res), steps=9, ckpt_path=ck,
               ckpt_every=2, ckpt_keep=3)
    assert r.rollbacks == 1
    assert max(r.losses[7:9]) > 1.5 * r.losses[5]    # the spike was real
    good = ckpt.restore(str(tmp_path / "ck-000005.npz"),
                        {"params": r.params, "opt": r.opt_state})
    assert _equal_trees(r.params, good["params"])
    for k in ("mu", "nu"):
        assert _equal_trees(r.opt_state[k], good["opt"][k])
    assert r.opt_state["step"] == good["opt"]["step"] == 6
    assert all(p.requires_grad and p.is_leaf
               for p in adamw.tree_leaves(r.params))


def test_corrupt_rolling_ckpt_falls_back_to_previous(tmp_path):
    ck = str(tmp_path / "ck.npz")
    res = ResilienceConfig(rollback_on_spike=True, spike_factor=1.5,
                           spike_patience=2, spike_warmup=3,
                           chaos=ChaosConfig(spike_steps=(6,),
                                             corrupt_ckpt_steps=(5,)))
    r = _train(_run_cfg(resilience=res), steps=9, ckpt_path=ck,
               ckpt_every=2, ckpt_keep=3)
    assert r.rollbacks == 1
    assert not ckpt.verify(str(tmp_path / "ck-000005.npz"))
    good = ckpt.restore(str(tmp_path / "ck-000003.npz"),
                        {"params": r.params, "opt": r.opt_state})
    assert _equal_trees(r.params, good["params"])
    assert r.opt_state["step"] == 4


def test_rollback_without_rolling_ckpts_is_rejected():
    res = ResilienceConfig(rollback_on_spike=True)
    with pytest.raises(ValueError, match="rollback_on_spike"):
        _train(_run_cfg(resilience=res), steps=2)


def test_straggler_delay_does_not_change_results(one_thread):
    res = ResilienceConfig(chaos=ChaosConfig(straggler_steps=(1, 2),
                                             straggler_delay_s=0.01))
    slow = _train(_run_cfg(resilience=res), steps=4)
    fast = _train(_run_cfg(resilience=ResilienceConfig()), steps=4)
    assert slow.losses == fast.losses
    assert slow.step_seconds[1] >= 0.0 and len(slow.step_seconds) == 4


def test_one_rank_has_no_links_to_measure():
    """Without a world (or on axes of size 1) there is no link to time:
    ``measured_ep_links`` gives None, the overlap model keeps the ladder
    constants (the same chunk count as without ``measured_comm``), and
    the replan probe observes no slowdown."""
    from repro_torch.core import comm_model
    arch = get_config(ARCH_ID).reduced()
    assert comm_model.measured_ep_links(None, ("data",)) == {"data": None}
    assert comm_model.measured_moe_links(None, pod_axis="pod") == {
        "near": None, "far": None}
    kw = dict(seq_len=32, global_batch=4, dispatch="a2a_pipelined",
              device="cpu")
    assert (model.build_ctx(arch, measured_comm=True, **kw).a2a_num_chunks
            == model.build_ctx(arch, **kw).a2a_num_chunks)
    pol = RecoveryPolicy(ResilienceConfig(replan_every=2, chaos=ChaosConfig(
        degraded_links=((0, "data", 64.0),))))
    assert pol.observe_links(None, ("data",), 2) == {}
