"""Training loop: the step (forward, backward, gradient sync, AdamW), the
guarded step of the resilient runtime, and ``train`` with rolling
checkpoints, rollback and the degraded-link replan (the counterpart of
``repro/training/trainer.py``).

On an EP world of ``n`` ranks every rank runs the model on its batch shard
with its expert shard and backpropagates its local loss divided by ``n``;
the all-to-all backwards carry each token's gradient back to the rank it
came from, so every expert shard's gradient holds its EP group's tokens.
The experts span a suffix of the world's axes (``model.make_ep_spec``);
the axes above it are data parallelism, whose replicas hold the same
shard.  Replicated parameters' gradients are summed over the world, the
expert shards' over the data-parallel axes (one all-reduce each).  The
clip norm counts every replicated parameter once and every expert shard
once (summed over the EP axes, not over the replicas), which is the
reference's ``global_norm`` over the global tree.  Logged metrics are
world means.

A world with a ``model`` axis (tensor parallelism) runs the same batch
shard on each of its model ranks, each with its slice of the weights;
every collective above spans the hierarchy with the model coordinate
fixed, so the ranks that hold the same slice sum their gradients.  The
clip norm adds the squares of each model-sharded leaf over the model
axis and counts every replicated leaf (and every whole stripe of a
``sharding.Stripes`` leaf) once.  Each process writes its own checkpoint
payload (its model slices and expert shard: ``ckpt.rank_path`` at its
process rank), a rollback restores only when every process's payload
verifies, and the guarded step's verdict is agreed over the model axis
too, so a fault on one model rank makes every rank of its data rank act
alike.  The replan's link readings are world means over every process
(``comm_model.measure_link``).

``RunConfig.microbatch`` ``m < global_batch`` accumulates float32
gradients over ``global_batch / m`` microbatches and divides by their
count, and averages every metric the same way (the reference's
``_accum_grads``).  The capacity plan stays sized for the global batch,
as the reference's does, so a microbatch's stages run below their
capacities and an MoE step differs from the full-batch one.

The port's AdamW updates in place, so the reference's skip ("keep the
previous trees") does not carry over: the guarded step reaches its
verdict (world-mean loss and all-reduced global norm finite) and asks the
policy for its action *before* the update, then applies it, skips it, or
leaves the rollback to the loop.  The verdict reads world quantities,
so every rank takes the same action.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from repro_torch import sharding
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.dispatch.base import EXPERT_PARAMS
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.optim import adamw


def expert_mask(params, ctx: transformer.ModelCtx) -> list:
    """One bool per leaf of ``params`` (``adamw.tree_leaves`` order): True
    for the leaves sharded over the EP ranks."""
    subs = transformer.layer_list(ctx.arch)
    mask = adamw.tree_map(lambda _: False, params)
    for layer, sub in zip(mask["layers"], subs):
        if sub.ffn == "moe":
            for name in EXPERT_PARAMS:
                if name in layer["ffn"]:
                    layer["ffn"][name] = True
    return adamw.tree_leaves(mask)


_MODEL_SPECS: dict = {}


def model_specs(params, ctx: transformer.ModelCtx) -> list:
    """One spec per leaf of ``params`` (``adamw.tree_leaves`` order): its
    ``model.param_specs`` entry (by path, kept a context), ``()`` for
    every leaf without a model axis."""
    if ctx.tp is None:
        return [()] * len(adamw.tree_leaves(params))
    hit = _MODEL_SPECS.get(id(ctx))
    if hit is None or hit[0] is not ctx:
        specs = model_lib.param_specs(model_lib.full_abstract_params(ctx),
                                      ctx)
        hit = _MODEL_SPECS[id(ctx)] = (
            ctx, dict(sharding._leaves_with_paths(specs)))
    return [hit[1][path] for path, _ in sharding._leaves_with_paths(params)]


def sync_grads(params, ctx: transformer.ModelCtx, grads: list | None = None
               ) -> tuple:
    """This rank's gradient tree after the world sum of the replicated
    leaves and the data-parallel sum of the expert leaves, and the global
    gradient norm.  ``grads`` (``tree_leaves``
    order) defaults to the parameters' ``.grad``.  On one rank: the
    gradients and their norm."""
    world = ctx.mesh
    if grads is None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in adamw.tree_leaves(params)]
    else:
        grads = list(grads)
    tp = ctx.tp
    if (world is None or world.size == 1) and tp is None:
        return _unflatten(params, grads), adamw.global_norm(grads)
    expert = expert_mask(params, ctx)
    ep_axes = ctx.ep.axis_names if ctx.ep is not None else ()
    dp_axes = tuple(a for a in world.axis_names
                    if a not in ep_axes and world.shape[a] > 1)
    for axes, want in ((None, False), (dp_axes, True)):
        idx = [i for i, e in enumerate(expert) if e == want]
        if not idx or axes == () or world.size == 1:
            continue
        flat = world.all_reduce_sum(
            torch.cat([grads[i].to(torch.float32).reshape(-1) for i in idx]),
            axes)
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].reshape(grads[i].shape).to(
                grads[i].dtype)
            off += n
    m = 1 if tp is None else tp.model
    # (split, whole) squares of each leaf: a split part sums over the
    # model axis, a whole one counts once
    sq = [sharding.split_squares(g, s, m)
          for g, s in zip(grads, model_specs(params, ctx))]
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    norm_sq = sum((w for (_, w), e in zip(sq, expert)
                   if w is not None and not e), zero)
    split = [s for (s, _), e in zip(sq, expert) if s is not None and not e]
    if split:
        norm_sq = norm_sq + world.all_reduce_sum(
            sum(split).reshape(1), ("model",))[0]
    if any(expert):
        # over the EP axes, then the model axis (every expert is sliced)
        e_sq = world.all_reduce_sum(
            sum(s if s is not None else w
                for (s, w), e in zip(sq, expert) if e).reshape(1), ep_axes)
        norm_sq = norm_sq + world.all_reduce_sum(e_sq, ("model",))[0]
    return _unflatten(params, grads), torch.sqrt(norm_sq)


def _unflatten(like, leaves: list):
    """``leaves`` (in ``adamw.tree_leaves`` order) in the shape of
    ``like``."""
    it = iter(leaves)
    return adamw.tree_map(lambda _: next(it), like)


def world_mean_metrics(metrics: dict, world) -> dict:
    """Detached float32 metrics, averaged over the ranks of ``world`` (None:
    one rank) in one all-reduce."""
    if world is None:
        return {k: v.detach().to(torch.float32) for k, v in metrics.items()}
    return world.mean(metrics)


def _opt_cfg(run: RunConfig) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(
        learning_rate=run.learning_rate, warmup_steps=run.warmup_steps,
        total_steps=run.total_steps, weight_decay=run.weight_decay,
        grad_clip=run.grad_clip)


def num_microbatches(run: RunConfig) -> int:
    """Microbatches a step accumulates over (1: none)."""
    m = run.microbatch
    if not m or m >= run.global_batch:
        return 1
    if run.global_batch % m:
        raise ValueError(f"global batch {run.global_batch} is not a multiple "
                         f"of microbatch {m}")
    return run.global_batch // m


def _backward(params, batch, ctx, run: RunConfig, loss_mult=None):
    """Forward and backward over this rank's batch.  Returns ``(grads,
    metrics)``: with one microbatch the gradients are left in ``.grad``
    (``grads`` None); with ``n`` they are the float32 sums over the
    microbatches divided by ``n``, and the metrics are averaged alike.
    ``loss_mult`` multiplies the differentiated loss (the chaos faults);
    the metrics stay raw."""
    world = 1 if ctx.mesh is None else ctx.mesh.size
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.grad = None

    def run_one(b):
        total, metrics = transformer.loss_fn(params, b, ctx,
                                             aux_weight=run.aux_weight)
        if loss_mult is not None:
            total = total * loss_mult
        (total / world).backward()
        return metrics

    n = num_microbatches(run)
    if n == 1:
        return None, run_one(batch)
    rows = batch["tokens"].shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows do not split into {n} microbatches")
    per = rows // n
    acc, msum = None, None
    for i in range(n):
        metrics = run_one({k: v[i * per:(i + 1) * per]
                           for k, v in batch.items()})
        # leaf by leaf, each .grad dropped once added: the step never holds
        # a second full-size copy of the gradients
        if acc is None:
            acc = []
            for p in leaves:
                acc.append(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                           if p.grad is None else p.grad.to(torch.float32))
                p.grad = None
        else:
            for a, p in zip(acc, leaves):
                if p.grad is not None:
                    a.add_(p.grad)
                p.grad = None
        m = {k: v.detach().to(torch.float32) for k, v in metrics.items()}
        msum = m if msum is None else {k: msum[k] + m[k] for k in m}
    return ([a.div_(n) for a in acc], {k: v / n for k, v in msum.items()})


def make_train_step(ctx: transformer.ModelCtx, run: RunConfig,
                    opt_cfg: adamw.AdamWConfig | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``: one forward and backward over this rank's batch (by
    microbatches when ``run.microbatch`` asks), the gradient sync, and an
    in-place AdamW update.  ``params`` are leaf tensors with
    ``requires_grad``."""
    opt_cfg = opt_cfg or _opt_cfg(run)
    num_microbatches(run)        # a bad microbatch fails here, not in a step

    def step(params, opt_state, batch):
        grads, metrics = _backward(params, batch, ctx, run)
        grads, gnorm = sync_grads(params, ctx, grads)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, grad_norm=gnorm)
        metrics = world_mean_metrics(metrics, ctx.mesh)
        return params, opt_state, dict(metrics, **opt_metrics)

    return step


def make_guarded_train_step(ctx: transformer.ModelCtx, run: RunConfig,
                            opt_cfg: adamw.AdamWConfig | None = None):
    """Guarded step: ``step(params, opt_state, batch, fault, classify) ->
    (params, opt, metrics, action)``.

    ``fault`` holds the chaos multipliers ``{"loss_mult", "grad_mult"}``
    (1.0 when nothing fires), which scale the differentiated loss, so the
    chain rule brings them to every gradient.  After the gradient sync the
    step reads ``[nonfinite, loss, dropped]`` to the host in one copy
    (``nonfinite`` is 1 unless the world-mean loss and the global norm are
    finite) and calls ``classify(verdict) -> "ok" | "skip" | "rollback"``
    (``RecoveryPolicy.classify``).  Only "ok" applies the update; on the
    other two the parameters and moments are left as they were.  The
    metrics carry ``nonfinite`` and the optimizer's ``grad_norm`` and
    ``lr`` in every case."""
    opt_cfg = opt_cfg or _opt_cfg(run)
    num_microbatches(run)        # a bad microbatch fails here, not in a step

    def step(params, opt_state, batch, fault, classify):
        grads, metrics = _backward(
            params, batch, ctx, run,
            loss_mult=fault["loss_mult"] * fault["grad_mult"])
        grads, gnorm = sync_grads(params, ctx, grads)
        metrics = world_mean_metrics(metrics, ctx.mesh)
        ok = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        metrics["nonfinite"] = 1.0 - ok.to(torch.float32)
        read = [metrics["nonfinite"], metrics["loss"]]
        if "dropped" in metrics:
            read.append(metrics["dropped"])
        read = torch.stack(read)
        if ctx.tp is not None:
            # one verdict for the model ranks of a data rank: a fault on
            # one of them is every one's (their losses agree bit for bit,
            # so the mean leaves a healthy loss as it was)
            read = ctx.tp.all_reduce_sum(read, ("model",)) / ctx.tp.model
            metrics["nonfinite"] = read[0]
        host = read.tolist()
        action = classify({"nonfinite": host[0], "loss": host[1],
                           "dropped": host[2] if len(host) > 2 else None})
        if action == "ok":
            params, opt_state, opt_metrics = adamw.apply_updates(
                params, grads, opt_state, opt_cfg, grad_norm=gnorm)
        else:
            opt_metrics = {"grad_norm": gnorm,
                           "lr": adamw.schedule(opt_cfg, opt_state["step"] + 1,
                                                gnorm.device)}
        return params, opt_state, dict(metrics, **opt_metrics), action

    return step


@dataclasses.dataclass
class TrainResult:
    losses: list
    metrics_history: list
    steps_per_sec: float
    params: object
    opt_state: object
    step_seconds: list = dataclasses.field(default_factory=list)
    # resilience accounting (0 on unguarded runs); the same counters ride
    # every logged metrics_history entry
    skipped_steps: int = 0
    rollbacks: int = 0
    replans: int = 0


def _rolling_path(ckpt_path: str, step: int) -> str:
    base, ext = os.path.splitext(ckpt_path)
    return f"{base}-{step:06d}{ext or '.npz'}"


def _prune_rolling(rolling: list, keep: int) -> None:
    while len(rolling) > keep:
        _, path = rolling.pop(0)
        for p in (path, path + ".meta.json"):
            if os.path.exists(p):
                os.unlink(p)


def _restore_last_good(rolling: list, state: dict, world):
    """Walk the rolling checkpoints newest first and restore the first one
    whose sha256 manifest verifies, into the live tensors of ``state``.
    On a world a step is taken only if every process's payload of it
    verifies, model ranks included (one all-reduce a candidate).  Returns
    ``(step, state)``."""
    for step, path in reversed(rolling):
        good = ckpt.verify(path)
        if world is not None and world.size * world.model > 1:
            bad = torch.tensor([0.0 if good else 1.0],
                               device=torch.device(world.device))
            good = float(world.all_reduce_sum(bad, world.every_axis)[0]) \
                == 0.0
        if good:
            # verify just hashed every leaf: the restore reads without
            # hashing them again
            return step, ckpt.restore_into(path, state, check_hashes=False)
    raise RuntimeError("rollback requested but no rolling checkpoint passes "
                       "integrity verification")


def train(arch: ArchConfig, run: RunConfig, mesh=None, *, steps: int,
          aux_mode: str | None = None, log_every: int = 10,
          ckpt_path: str | None = None, ckpt_every: int = 0,
          ckpt_keep: int = 3, data_seed: int | None = None,
          verbose: bool = True, params=None, device="cuda") -> TrainResult:
    """End-to-end training driver on this rank of ``mesh`` (an
    ``launch.mesh.EPWorld``, or None for one rank).

    ``params`` (this rank's tree, e.g. from ``convert.params_from_numpy``)
    defaults to ``model.init_params`` from ``run.seed``.  Every step is
    timed on the host clock after a device synchronize
    (``TrainResult.step_seconds``).

    ``ckpt_every > 0`` writes rolling checkpoints (``<base>-<step>.npz``,
    the newest ``ckpt_keep`` kept, each with its sha256 manifest; one
    payload a process on a world, ``ckpt.rank_path``) while the policy is
    healthy; ``ckpt_path`` also gets the final state.  ``run.resilience``
    (a ``resilience.ResilienceConfig``) switches the loop onto the guarded
    step: skip on non-finite loss or gradients, rollback on a sustained
    loss spike, and the degraded-link replan at ``replan_every``
    boundaries, which builds a new context and step.
    """
    aux_mode = aux_mode or run.aux_mode
    device = mesh.device if mesh is not None else device
    if mesh is not None and run.topology:
        want = run.mesh_axis_sizes()
        if tuple(mesh.axis_sizes) != want:
            raise ValueError(f"RunConfig.topology {run.topology!r} implies "
                             f"hierarchy sizes {want} but the world has "
                             f"{tuple(mesh.axis_sizes)}")
    ctx = model_lib.build_ctx(arch, mesh, seq_len=run.seq_len,
                              global_batch=run.global_batch,
                              aux_mode=aux_mode, remat=run.remat,
                              dispatch=run.dispatch,
                              a2a_num_chunks=run.a2a_num_chunks,
                              dispatch_override=run.dispatch_override,
                              use_pallas=run.use_pallas,
                              wire_codec=run.wire_codec, device=device)
    res = run.resilience
    guarded = res is not None
    policy = chaos = None
    if guarded:
        from repro_torch.resilience import chaos as chaos_lib
        from repro_torch.resilience.policy import RecoveryPolicy
        policy = RecoveryPolicy(res)
        chaos = res.chaos
        if res.rollback_on_spike and not (ckpt_path and ckpt_every > 0):
            raise ValueError(
                "ResilienceConfig.rollback_on_spike needs ckpt_path and "
                "ckpt_every > 0: rolling checkpoints are the rollback "
                "target")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(run.seed)
        params = model_lib.init_params(ctx, gen, device)
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init_state(params)

    def make_fn(c):
        return (make_guarded_train_step(c, run) if guarded
                else make_train_step(c, run))
    step_fn = make_fn(ctx)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=run.seq_len,
                                  global_batch=run.global_batch,
                                  seed=data_seed if data_seed is not None
                                  else run.seed), arch)
    # one checkpoint payload a process: model ranks hold other slices
    rank, size = ((0, 1) if mesh is None
                  else (mesh.process_rank, mesh.size * mesh.model))
    micro = run.microbatch if num_microbatches(run) > 1 else 0
    cuda = torch.device(device).type == "cuda"
    losses, history, step_seconds = [], [], []
    rolling = []                         # [(step, path)] oldest first
    t0 = time.time()
    for i in range(steps):
        # degraded-link fallback: probe at replan boundaries only (a plan
        # change means a new context and step)
        if (guarded and res.replan_every and i > 0
                and i % res.replan_every == 0 and ctx.plan is not None):
            slow = policy.observe_links(mesh, ctx.ep.axis_names, i)
            new_ctx = policy.replan(ctx, slow)
            if new_ctx is not None:
                ctx = new_ctx
                step_fn = make_fn(ctx)
                if verbose:
                    print(f"step {i:5d} replan: caps -> {ctx.plan.caps}",
                          flush=True)
        if chaos is not None:
            chaos_lib.maybe_straggle(chaos, i)
        batch = shard_batch(data.batch(i), mesh, device, microbatch=micro)
        ts = time.perf_counter()
        if guarded:
            scales = chaos_lib.fault_scales(chaos, i)
            params, opt_state, metrics, action = step_fn(
                params, opt_state, batch, scales,
                lambda verdict: policy.classify(i, verdict))
            if action == "rollback":
                at, state = _restore_last_good(
                    rolling, {"params": params, "opt": opt_state}, mesh)
                params, opt_state = state["params"], state["opt"]
                policy.on_rollback()
                if verbose:
                    print(f"step {i:5d} rollback -> checkpoint of step {at}",
                          flush=True)
            elif action == "ok" and scales["param_scale"] != 1.0:
                # loss-spike fault: wreck the updated params between steps
                with torch.no_grad():
                    for p in adamw.tree_leaves(params):
                        p.mul_(scales["param_scale"])
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        step_seconds.append(time.perf_counter() - ts)
        if i % log_every == 0 or i == steps - 1:
            m = {k: (float(v) if v.dim() == 0 else [float(x) for x in v])
                 for k, v in metrics.items()}
            m.update(policy.counters() if policy is not None else
                     {"skipped_steps": 0, "rollbacks": 0, "replans": 0,
                      "drop_alarms": 0})
            losses.append(m["loss"])
            history.append(m)
            if verbose:
                fb = m.get("frac_by_level")
                extra = (" frac_by_level=[" +
                         ",".join(f"{x:.2f}" for x in fb) + "]"
                         if fb else "")
                print(f"step {i:5d} loss {m['loss']:.4f} "
                      f"nll {m['nll']:.4f} aux {m.get('aux', 0):.4f}"
                      f"{extra}", flush=True)
        if (ckpt_path and ckpt_every > 0 and (i + 1) % ckpt_every == 0
                and (policy is None or policy.healthy)):
            rp = ckpt.rank_path(_rolling_path(ckpt_path, i), rank, size)
            ckpt.save(rp, {"params": params, "opt": opt_state}, step=i)
            rolling.append((i, rp))
            _prune_rolling(rolling, ckpt_keep)
            if chaos is not None and chaos_lib.should_corrupt(chaos, i):
                chaos_lib.corrupt_checkpoint(rp, chaos.seed)
    dt = time.time() - t0
    if ckpt_path:
        ckpt.save(ckpt.rank_path(ckpt_path, rank, size),
                  {"params": params, "opt": opt_state}, step=steps)
    counters = policy.counters() if policy is not None else {}
    return TrainResult(losses=losses, metrics_history=history,
                       steps_per_sec=steps / max(dt, 1e-9), params=params,
                       opt_state=opt_state, step_seconds=step_seconds,
                       skipped_steps=counters.get("skipped_steps", 0),
                       rollbacks=counters.get("rollbacks", 0),
                       replans=counters.get("replans", 0))
