"""Checks shared by the parity tests of the xLSTM, Whisper and InternVL2
families (``tests/test_torch_xlstm.py``, ``test_torch_whisper.py``,
``test_torch_vlm.py``): each builds a reduced reference model once, hands
its weights to the port through ``params_from_numpy``, and holds the
port's loss, gradients, trainer steps and served tokens against the
reference's (float32, rtol = atol = 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro import sharding
from repro.configs import base as jbase
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.serving import engine as jengine
from repro.serving.scheduler import Request as JRequest
from repro.training import trainer as jtrainer
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.models import model, transformer
from repro_torch.models.convert import (_tensor, opt_state_from_numpy,
                                        params_from_numpy)
from repro_torch.optim import adamw
from repro_torch.serving import engine
from repro_torch.serving.scheduler import Request
from repro_torch.training import trainer

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 32, 4


def close(got, want):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def close_scaled(got, want):
    """|got - want| <= 1e-4 + 1e-4 * max|want| over the tensor.  For the
    xLSTM's gradients, where the mLSTM's division by max(|den|, exp(-m))
    amplifies float32 rounding: the reference's own jitted and op-by-op
    gradients of the reduced model lie 8.7e-4 apart on the embedding
    table (largest entry 2.95), the port's 2.5e-4 from the jitted ones."""
    got = got.detach() if torch.is_tensor(got) else got
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL["atol"] + TOL["rtol"] * np.abs(want).max(), err


def to_torch(tree):
    """A jax tree as CPU tensors, dict keys sorted (as jax.grad's trees
    come back), so the leaf lists of two trees line up."""
    if isinstance(tree, dict):
        return {k: to_torch(tree[k]) for k in sorted(tree)}
    return _tensor(np.asarray(tree), "cpu")


def shapes(tree, path=()):
    if isinstance(tree, dict):
        return sum((shapes(tree[k], path + (k,)) for k in sorted(tree)), [])
    if isinstance(tree, list):
        return sum((shapes(v, path + (i,)) for i, v in enumerate(tree)), [])
    return [(path, tuple(tree.shape), tree.dtype)]


def rules(mesh):
    return sharding.axis_rules(jmodel.default_rules(mesh))


def build(mesh, arch_id: str, **kw):
    """(jax ctx, jax params, port ctx, port params) of reduced
    ``arch_id``, the weights the reference's ``init_params`` from key 0;
    ``kw`` goes to both ``build_ctx``."""
    jctx = jmodel.build_ctx(jbase.get_config(arch_id).reduced(), mesh,
                            seq_len=SEQ, global_batch=BATCH,
                            aux_mode="none", **kw)
    with mesh, rules(mesh):
        jparams = jax.jit(lambda key: jmodel.init_params(key, jctx))(
            jax.random.PRNGKey(0))
    ctx = model.build_ctx(base.get_config(arch_id).reduced(), seq_len=SEQ,
                          global_batch=BATCH, aux_mode="none", device="cpu",
                          **kw)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               ctx, "cpu")
    return jctx, jparams, ctx, params


def batches(arch, jarch, step: int = 0) -> dict:
    """Both packages' ``SyntheticLM`` batch of ``step`` (frontends
    included), checked bit-equal; returned as numpy arrays."""
    cfg = dict(vocab_size=arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
               seed=0)
    want = jpipeline.SyntheticLM(jpipeline.DataConfig(**cfg), jarch).batch(
        step)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**cfg), arch).batch(step)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    return {k: np.asarray(v) for k, v in want.items()}


def check_loss_and_grads(mesh, built, batch, grads_close=close) -> dict:
    """``loss_fn`` on ``batch`` (numpy) in both packages: the loss, every
    metric and every gradient (by ``grads_close``).  Returns the port's
    metrics."""
    jctx, jparams, ctx, params = built
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh, rules(mesh):
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jtransformer.loss_fn(p, jbatch, jctx),
            has_aux=True))(jparams)
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, m = transformer.loss_fn(
            params, {k: torch.from_numpy(np.array(v))
                     for k, v in batch.items()}, ctx)
        loss.backward()
        grads = [p.grad.detach().clone() for p in leaves]
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    close(loss, np.asarray(jloss))
    assert set(m) == set(jm) == {"nll", "aux", "loss"}
    for k in m:
        close(m[k], jm[k])
    want = adamw.tree_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), ctx, "cpu"))
    assert len(want) == len(grads)
    for a, b in zip(grads, want):
        grads_close(a, b)
    return m


def check_trainer_steps(mesh, built, steps: int = 3,
                        from_reference_state: bool = False,
                        grad_norm_rtol: float = TOL["rtol"]):
    """``steps`` steps (lr 3e-4 after a one-step warmup, no aux loss) on
    the trainer's ``SyntheticLM`` batches (frontends included).  The port's
    ``trainer.train`` runs free from the reference's weights: every step's
    loss, nll, aux and grad norm at 1e-4.  With ``from_reference_state``
    only its first step is held so; then each port step
    (``make_train_step``) starts from the reference's state of that step,
    params and AdamW moments through ``opt_state_from_numpy``: its metrics
    at 1e-4 and its updated params at rtol 1e-4, atol 2 lr (AdamW's
    normalized update moves a near-zero gradient by up to lr either way,
    so f32 rounding that flips its sign moves the two params 2 lr apart;
    the reduced xLSTM's second step has one such entry in 131072).  The
    grad norms of the steps from the reference's state are held at
    ``grad_norm_rtol``."""
    jctx, jparams, ctx, _ = built
    run_kw = dict(seq_len=SEQ, global_batch=BATCH, warmup_steps=1, seed=0,
                  aux_mode="none")
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=jctx.arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0), jctx.arch)
    keys = ("loss", "nll", "aux", "grad_norm")
    with mesh, rules(mesh):
        jstep = jax.jit(jtrainer.make_train_step(jctx,
                                                 jbase.RunConfig(**run_kw)))
        jp, jo = jax.device_put((jparams, jadamw.init_state(jparams)),
                                NamedSharding(mesh, PartitionSpec()))
        states, want = [], []
        for i in range(steps):
            states.append((jp, jo))
            jp, jo, m = jstep(jp, jo, data.batch(i))
            want.append(m)
    got = trainer.train(ctx.arch, base.RunConfig(**run_kw), None,
                        steps=steps, log_every=1, verbose=False,
                        params=params_from_numpy(
                            jax.tree_util.tree_map(np.array, jparams), ctx,
                            "cpu"),
                        device="cpu").metrics_history
    assert len(got) == len(want) == steps
    for g, w in list(zip(got, want))[:1 if from_reference_state else steps]:
        for k in keys:
            close(g[k], w[k])
    if not from_reference_state:
        return
    step = trainer.make_train_step(ctx, base.RunConfig(**run_kw))
    pdata = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=ctx.arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0), ctx.arch)
    for i, (jp, jo) in enumerate(states):
        params = params_from_numpy(jax.tree_util.tree_map(np.array, jp),
                                   ctx, "cpu")
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        opt = opt_state_from_numpy(jax.tree_util.tree_map(np.array, jo),
                                   ctx, "cpu")
        params, opt, m = step(params, opt, pdata.batch(i))
        for k in keys[:-1]:
            close(m[k], want[i][k])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(want[i]["grad_norm"]),
                                   rtol=grad_norm_rtol)
        assert opt["step"] == i + 1
        nxt = states[i + 1][0] if i + 1 < steps else None
        if nxt is not None:
            final = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             nxt), ctx, "cpu")
            for a, b in zip(adamw.tree_leaves(params),
                            adamw.tree_leaves(final)):
                np.testing.assert_allclose(
                    a.detach().numpy(), b.numpy(), rtol=1e-4,
                    atol=2 * base.RunConfig().learning_rate)


def prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def serve_both(built, serve_cfg: dict, prompt_lens, budgets, frontends=None,
               ctx=None) -> tuple:
    """``ServingEngine.run`` of both packages on the same requests (with
    ``frontends[i]`` as request i's frontend array, or none): the
    reference's greedy tokens and the port's report (through ``ctx``,
    default the built one)."""
    jctx, jparams, ctx0, params = built
    ctx = ctx or ctx0
    ps = prompts(ctx.arch.vocab_size, prompt_lens, seed=3)
    fr = frontends if frontends is not None else [None] * len(ps)
    rep = jengine.ServingEngine(jparams, jctx,
                                jengine.ServeConfig(**serve_cfg)).run(
        [JRequest(uid=i, tokens=p, max_new_tokens=m,
                  frontend=None if f is None else jnp.asarray(f))
         for i, (p, m, f) in enumerate(zip(ps, budgets, fr))])
    want = [[int(v) for v in rep.tokens_for(i)] for i in range(len(ps))]
    got = engine.ServingEngine(params, ctx,
                               engine.ServeConfig(**serve_cfg)).run(
        [Request(uid=i, tokens=p, max_new_tokens=m,
                 frontend=None if f is None else torch.from_numpy(f))
         for i, (p, m, f) in enumerate(zip(ps, budgets, fr))])
    assert got.total_new_tokens == sum(budgets)
    return want, got


class TwoRankStub:
    """A stand-in world of two ranks whose all-gather stacks two copies
    of a rank's rows: enough for ``gather_cache_rows``' cuts."""
    size = 2
    axis_names = ("data",)

    def all_gather(self, t, axes):
        return torch.cat([t, t])
