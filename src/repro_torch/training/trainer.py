"""Training loop: the step (forward, backward, gradient sync, AdamW) and
the unguarded driver (the counterpart of ``repro/training/trainer.py``'s
``make_train_step`` and ``train``, without the resilient runtime and the
checkpoints, which are not ported yet).

On an EP world of ``n`` ranks every rank runs the model on its batch shard
with its expert shard and backpropagates its local loss divided by ``n``;
the all-to-all backwards carry each token's gradient back to the rank it
came from, so every expert shard's gradient is complete on its own rank.
Replicated parameters' gradients are summed over the ranks (one
all-reduce).  The clip norm counts every replicated parameter once and
every expert shard once, which is the reference's ``global_norm`` over
the global tree.  Logged metrics are world means.
"""

from __future__ import annotations

import dataclasses
import time

import torch

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


def sync_grads(params, ctx: transformer.ModelCtx) -> tuple:
    """This rank's gradient tree after the world sum of the replicated
    leaves, and the global gradient norm.  On one rank: the gradients and
    their norm."""
    world = ctx.mesh
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in adamw.tree_leaves(params)]
    if world is None or world.size == 1:
        return _unflatten(params, grads), adamw.global_norm(grads)
    expert = expert_mask(params, ctx)
    rep = [i for i, e in enumerate(expert) if not e]
    flat = world.all_reduce_sum(
        torch.cat([grads[i].to(torch.float32).reshape(-1) for i in rep]))
    off = 0
    for i in rep:
        n = grads[i].numel()
        grads[i] = flat[off:off + n].reshape(grads[i].shape).to(
            grads[i].dtype)
        off += n
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
    sq_rep = sum(s for s, e in zip(sq, expert) if not e)
    sq_exp = world.all_reduce_sum(
        sum(s for s, e in zip(sq, expert) if e).reshape(1))[0]
    return _unflatten(params, grads), torch.sqrt(sq_rep + sq_exp)


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


def make_train_step(ctx: transformer.ModelCtx, run: RunConfig,
                    opt_cfg: adamw.AdamWConfig | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``: one forward and backward over this rank's batch, the
    gradient sync, and an in-place AdamW update.  ``params`` are leaf
    tensors with ``requires_grad``."""
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig(
            learning_rate=run.learning_rate, warmup_steps=run.warmup_steps,
            total_steps=run.total_steps, weight_decay=run.weight_decay,
            grad_clip=run.grad_clip)
    if run.microbatch and run.microbatch < run.global_batch:
        raise NotImplementedError("microbatch gradient accumulation is not "
                                  "ported yet")
    n = 1 if ctx.mesh is None else ctx.mesh.size

    def step(params, opt_state, batch):
        for p in adamw.tree_leaves(params):
            p.grad = None
        total, metrics = transformer.loss_fn(params, batch, ctx,
                                             aux_weight=run.aux_weight)
        (total / n).backward()
        grads, gnorm = sync_grads(params, ctx)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, grad_norm=gnorm)
        metrics = world_mean_metrics(metrics, ctx.mesh)
        return params, opt_state, dict(metrics, **opt_metrics)

    return step


@dataclasses.dataclass
class TrainResult:
    losses: list
    metrics_history: list
    steps_per_sec: float
    params: object
    opt_state: object
    step_seconds: list = dataclasses.field(default_factory=list)


def train(arch: ArchConfig, run: RunConfig, mesh=None, *, steps: int,
          aux_mode: str | None = None, log_every: int = 10,
          data_seed: int | None = None, verbose: bool = True,
          params=None, device="cuda") -> TrainResult:
    """End-to-end training driver on this rank of ``mesh`` (an
    ``launch.mesh.EPWorld``, or None for one rank).

    ``params`` (this rank's tree, e.g. from ``convert.params_from_numpy``)
    defaults to ``model.init_params`` from ``run.seed``.  Every step is
    timed on the host clock after a device synchronize
    (``TrainResult.step_seconds``).
    """
    if run.resilience is not None:
        raise NotImplementedError("the resilient runtime is not ported yet")
    aux_mode = aux_mode or run.aux_mode
    device = mesh.device if mesh is not None else device
    if mesh is not None and run.topology:
        from repro_torch.core.topology import axis_sizes_from_spec
        want = axis_sizes_from_spec(run.topology)
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
    if mesh is not None and ctx.ep.ep_world != mesh.size:
        raise NotImplementedError(
            f"experts span {ctx.ep.ep_world} of {mesh.size} ranks: data "
            f"parallelism over the other axes is not ported yet")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(run.seed)
        params = model_lib.init_params(ctx, gen, device)
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init_state(params)
    step_fn = make_train_step(ctx, run)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=run.seq_len,
                                  global_batch=run.global_batch,
                                  seed=data_seed if data_seed is not None
                                  else run.seed))
    cuda = torch.device(device).type == "cuda"
    losses, history, step_seconds = [], [], []
    t0 = time.time()
    for i in range(steps):
        batch = shard_batch(data.batch(i), mesh, device)
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        step_seconds.append(time.perf_counter() - ts)
        if i % log_every == 0 or i == steps - 1:
            m = {k: (float(v) if v.dim() == 0 else [float(x) for x in v])
                 for k, v in metrics.items()}
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
    dt = time.time() - t0
    return TrainResult(losses=losses, metrics_history=history,
                       steps_per_sec=steps / max(dt, 1e-9), params=params,
                       opt_state=opt_state, step_seconds=step_seconds)
