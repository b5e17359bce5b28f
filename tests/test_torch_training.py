"""The port's training slice on one rank against the JAX package on the CPU.

- ``SyntheticLM`` batches: bit-equal.
- ``adamw.apply_updates`` on a small tree over 3 steps (clipping active):
  params, moments, grad norm and learning rate within 1e-6.
- The ``a2a`` engine through ``_moe_block`` on the unit world, kernels
  wanted (the fused local branch, K4's plain version) and off (permute ->
  chain -> grouped FFN -> unpermute, plain): output, every
  ``METRIC_KEYS`` entry, and the gradients of a scalar of the output and
  the aux loss w.r.t. every MoE parameter and the input, against the
  reference; and the output against the ``einsum`` oracle (capacity equal
  to the token count, so nothing drops).  rtol = atol = 1e-4.
- 3 trainer steps of ``gpt3_medium_moe.reduced()`` (float32) on mesh
  (1, 1) with ``aux_mode="ta"``, ``dispatch="a2a"``: per-step loss, nll,
  aux and frac_by_level within 1e-4, final params within atol 2e-4 (3
  AdamW steps at lr 3e-4: an update whose sign rests on an f32-rounding-
  sized gradient can move a weight by up to 2 lr).

Both sides start from the reference's ``init_params``, carried over by
``convert.params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sharding
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer
from repro_torch.configs.base import RunConfig, get_config
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.data import pipeline
from repro_torch.models import model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.training import trainer

torch.set_num_threads(2)

ARCH_ID = "gpt3_medium_moe"
SEQ, BATCH = 32, 4
TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want, **tol):
    got, want = (a.detach() if torch.is_tensor(a) else a
                 for a in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_synthetic_batches_bit_equal(seed, step):
    cfg = dict(vocab_size=512, seq_len=24, global_batch=4, seed=seed)
    want = jpipeline.SyntheticLM(jpipeline.DataConfig(**cfg)).batch(step)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**cfg)).batch(step)
    for k in ("tokens", "labels", "loss_mask"):
        assert got[k].dtype == {"tokens": torch.int32, "labels": torch.int32,
                                "loss_mask": torch.float32}[k]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_adamw_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "nest": [{"e": (2, 3, 4)}]}
    p0 = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * 3).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple)) for _ in range(3)]
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
               grad_clip=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jadamw.init_state(jp)
    tp = adamw.tree_map(t, p0)
    ts = adamw.init_state(tp)
    for g in grads:
        jp, js, jm = jadamw.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js,
            jadamw.AdamWConfig(**cfg))
        tp, ts, tm = adamw.apply_updates(tp, adamw.tree_map(t, g), ts,
                                         adamw.AdamWConfig(**cfg))
        close(tm["grad_norm"], jm["grad_norm"], rtol=1e-6, atol=1e-6)
        close(tm["lr"], jm["lr"], rtol=1e-6, atol=1e-6)
    for a, b in zip(adamw.tree_leaves([tp, ts["mu"], ts["nu"]]),
                    jax.tree_util.tree_leaves([jp, js["mu"], js["nu"]])):
        close(a, b, rtol=1e-6, atol=1e-6)
    assert ts["step"] == int(js["step"]) == 3


# ---------------------------------------------------------------------------
# the a2a engine on the unit world
# ---------------------------------------------------------------------------


def build_ctxs(mesh11, **kw):
    use_pallas = kw.pop("use_pallas", None)
    jctx = jmodel.build_ctx(jax_get_config(ARCH_ID).reduced(), mesh11,
                            seq_len=SEQ, global_batch=BATCH, **kw)
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), seq_len=SEQ,
                          global_batch=BATCH, use_pallas=use_pallas,
                          device="cpu", **kw)
    return jctx, ctx


def ref_params(mesh11, jctx, seed=0):
    with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
        return jmodel.init_params(jax.random.PRNGKey(seed), jctx,
                                  rules=jmodel.default_rules(mesh11))


@pytest.fixture(scope="module")
def weights(mesh11):
    jctx, ctx = build_ctxs(mesh11, aux_mode="ta")
    jparams = ref_params(mesh11, jctx)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(tree, ctx, "cpu")


@pytest.mark.parametrize("aux_mode", ["ta", "lb"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_a2a_engine_matches_reference_and_oracle(mesh11, weights, aux_mode,
                                                 use_pallas):
    jparams, params = weights
    jctx, ctx = build_ctxs(mesh11, aux_mode=aux_mode, use_pallas=use_pallas)
    assert ctx.plan.caps == jctx.plan.caps
    rng = np.random.default_rng(5)
    d = ctx.arch.d_model
    x = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    r = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["groups"])["sub0"]
    jctx_ref = dataclasses.replace(jctx, use_pallas=None)

    def jloss(p, xx):
        y, m = jtransformer._moe_block(p, xx, jctx_ref, decode=False,
                                       layer_idx=1)
        return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)
    (_, (jy, jm)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp["ffn"], jnp.asarray(x))

    p = {k: (v.detach().clone().requires_grad_(True) if torch.is_tensor(v)
             else {kk: vv.detach().clone().requires_grad_(True)
                   for kk, vv in v.items()})
         for k, v in params["layers"][1]["ffn"].items()}
    xt = t(x).requires_grad_(True)
    y, m = transformer._moe_block(p, xt, ctx, decode=False, layer_idx=1)
    (torch.sum(y * t(r)) + m["aux_loss"]).backward()
    close(y, jy)
    assert set(m) == set(dispatch_lib.METRIC_KEYS) == set(jm)
    for k in dispatch_lib.METRIC_KEYS:
        close(m[k], jm[k])
    close(xt.grad, jg[1])
    close(p["gate"]["w"].grad, jg[0]["gate"]["w"])
    for k in ("w_in", "w_out"):
        close(p[k].grad, jg[0][k])

    if aux_mode == "lb":      # the einsum oracle's gate has no levels
        T = BATCH * SEQ
        oracle = dispatch_lib.make_engine(
            "einsum", cfg=ctx.moe_cfg, ep=ctx.ep, gate_cfg=ctx.gate_cfg,
            capacity=T)
        y_or, m_or = oracle(p, t(x).reshape(T, d))
        close(y.reshape(T, d), y_or)
        close(m["aux_loss"], m_or["aux_loss"])
        assert float(m["dropped"]) == float(m_or["dropped"]) == 0.0


def test_unported_paths_and_options_raise():
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), seq_len=SEQ,
                          global_batch=BATCH, device="cpu")
    with pytest.raises(NotImplementedError, match="comm_model"):
        dispatch_lib.make_engine("a2a_pipelined", cfg=ctx.moe_cfg, ep=ctx.ep,
                                 gate_cfg=ctx.gate_cfg, plan=ctx.plan)
    with pytest.raises(NotImplementedError, match="fused_xent"):
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                 "labels": torch.zeros((1, 4), dtype=torch.int32)}
        transformer.loss_fn(None, batch,
                            dataclasses.replace(ctx, fused_xent=True))
    with pytest.raises(NotImplementedError, match="microbatch"):
        trainer.make_train_step(ctx, RunConfig(global_batch=4, microbatch=2))
    with pytest.raises(NotImplementedError, match="remat"):
        model.build_ctx(ctx.arch, remat=True, device="cpu")


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [None, True])
def test_trainer_matches_reference(mesh11, use_pallas):
    steps = 3
    run_kw = dict(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                  aux_mode="ta", dispatch="a2a", seed=0)
    jarch = jax_get_config(ARCH_ID).reduced()
    want = jtrainer.train(jarch, JRunConfig(**run_kw), mesh11, steps=steps,
                          log_every=1, verbose=False)
    jctx, ctx = build_ctxs(mesh11, aux_mode="ta")
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params(mesh11, jctx)), ctx,
        "cpu")
    got = trainer.train(get_config(ARCH_ID).reduced(),
                        RunConfig(use_pallas=use_pallas, **run_kw), None,
                        steps=steps, log_every=1, verbose=False,
                        params=params, device="cpu")
    assert len(got.metrics_history) == len(want.metrics_history) == steps
    for g, w in zip(got.metrics_history, want.metrics_history):
        for k in ("loss", "nll", "aux", "frac_by_level", "dropped",
                  "grad_norm", "lr"):
            close(g[k], w[k])
    final = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                     want.params), ctx, "cpu")
    for a, b in zip(adamw.tree_leaves(got.params), adamw.tree_leaves(final)):
        close(a, b, rtol=1e-4, atol=2e-4)
    assert len(got.step_seconds) == steps
