"""Parity of the port's dense decoders (``olmo_1b``, ``granite_3_2b``,
``internlm2_1_8b``, ``minitron_4b``) with the JAX package on the CPU.

- Each config and its ``reduced()`` equal the reference's field for field
  (``tie_embeddings`` included), and ``layer_plan`` gives one dense
  attention layer repeated ``num_layers`` times.
- ``params_from_numpy`` carries each reference model across, and the
  port's own ``init_params`` makes the same tree (OLMo's
  ``nonparam_ln`` norms hold no leaves).
- ``loss_fn`` of each reduced config: the loss, every metric and every
  gradient.
- ``train``: three trainer steps of reduced ``internlm2_1_8b``; and the
  counterpart of ``test_system.py::test_grad_accumulation_equivalence``:
  one step with ``microbatch=2`` against the full-batch step (the
  reference test's rel 1e-4 on the loss, atol 1e-4 / rtol 1e-3 on the
  first parameter leaf), each against the reference's own step.
- ``decode.prefill`` of a right-padded pack and three greedy decode steps
  of ``olmo_1b`` (``nonparam_ln``) and ``granite_3_2b`` (GQA 4/4 at
  ``reduced()``, the tied unembedding): the logits, the greedy tokens
  (exact) and the KV caches.
- ``ServingEngine.run`` with ``use_flash=True`` (K5's entry, its plain
  version on CPU tensors): exactly the reference engine's greedy tokens.
- ``launch.serve`` and ``launch.train`` with ``--arch olmo_1b`` and
  ``--arch internlm2_1_8b``, ``--reduced --device cpu``.

Both packages compute with the reference's ``init_params`` weights (as
numpy, through ``params_from_numpy``) on ``SyntheticLM`` batches; float32
at ``reduced()`` size (2 layers, d 256, 4 heads of 64, vocab 512);
rtol = atol = 1e-4.  Each reference model is built once, in a module
fixture; its gradients and steps run under ``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

torch = pytest.importorskip("torch")

from repro import sharding
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro.serving.scheduler import Request as JRequest
from repro.training import trainer as jtrainer
from repro_torch.configs.base import RunConfig, get_config
from repro_torch.data import pipeline
from repro_torch.models import model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.serving import batching, engine
from repro_torch.serving.scheduler import Request
from repro_torch.training import trainer

torch.set_num_threads(2)

ARCH_IDS = ("olmo_1b", "granite_3_2b", "internlm2_1_8b", "minitron_4b")
TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 32, 4
CONFIG_FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
                 "num_kv_heads", "d_ff", "vocab_size", "head_dim", "norm",
                 "activation", "rope_theta", "sliding_window", "qkv_bias",
                 "dtype", "source", "tie_embeddings")


def close(got, want, **tol):
    got, want = (a.detach() if torch.is_tensor(a) else a
                 for a in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def build(mesh, arch_id):
    """(jax ctx, jax params, port ctx, port params) of reduced ``arch_id``,
    the weights the reference's ``init_params`` from key 0."""
    jctx = jmodel.build_ctx(jax_get_config(arch_id).reduced(), mesh,
                            seq_len=SEQ, global_batch=BATCH, aux_mode="none")
    ctx = model.build_ctx(get_config(arch_id).reduced(), seq_len=SEQ,
                          global_batch=BATCH, aux_mode="none", device="cpu")
    with mesh, sharding.axis_rules(jmodel.default_rules(mesh)):
        jparams = jax.jit(lambda key: jmodel.init_params(key, jctx))(
            jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               ctx, "cpu")
    return jctx, jparams, ctx, params


@pytest.fixture(scope="module")
def models(mesh11):
    return {a: build(mesh11, a) for a in ARCH_IDS}


def shapes(tree, path=()):
    if isinstance(tree, dict):
        return sum((shapes(tree[k], path + (k,)) for k in sorted(tree)), [])
    if isinstance(tree, list):
        return sum((shapes(v, path + (i,)) for i, v in enumerate(tree)), [])
    return [(path, tuple(tree.shape), tree.dtype)]


def test_configs_reduced_and_layer_plans_match_reference():
    hds = {}
    for aid in ARCH_IDS:
        for full in (True, False):
            jarch, arch = jax_get_config(aid), get_config(aid)
            if not full:
                jarch, arch = jarch.reduced(), arch.reduced()
            for f in CONFIG_FIELDS:
                assert getattr(arch, f) == getattr(jarch, f), (aid, f)
            assert arch.moe is None and arch.mla is None and not arch.ssm_kind
            assert arch.head_dim_ == jarch.head_dim_
            for f in dataclasses.fields(jarch):   # fields the port lacks
                if not hasattr(arch, f.name):
                    assert getattr(jarch, f.name) == f.default, (aid, f.name)
            jprefix, jgroup, jn = jtransformer.layer_plan(jarch)
            prefix, group, n = transformer.layer_plan(arch)
            assert (len(prefix), n) == (len(jprefix), jn) == (
                0, arch.num_layers)
            assert [(s.mixer, s.ffn) for s in group] == [
                (s.mixer, s.ffn) for s in jgroup] == [("attn", "mlp")]
            if full:
                hds[aid] = arch.head_dim_
            else:
                assert arch.num_layers == 2 and arch.head_dim_ == 64
    # the widths the card serves: three at head dim 128, granite at 64
    assert hds == {"olmo_1b": 128, "granite_3_2b": 64,
                   "internlm2_1_8b": 128, "minitron_4b": 128}
    assert get_config("granite_3_2b").tie_embeddings
    assert get_config("olmo_1b").norm == "nonparam_ln"


def test_converted_params_match_the_ports_own_init(models):
    for aid, (_, _, ctx, params) in models.items():
        own = model.init_params(ctx, torch.Generator().manual_seed(0), "cpu")
        assert shapes(params) == shapes(own), aid
        assert set(params) == {"embed", "final_norm", "layers"}
        for layer in params["layers"]:
            assert set(layer["mixer"]) == {"wq", "wk", "wv", "wo"}
            assert set(layer["ffn"]) == {"w_in", "w_gate", "w_out"}
            assert (layer["norm1"] == {}) == (aid == "olmo_1b"), aid


def _batch(arch):
    b = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0)).batch(0)
    return {k: np.asarray(v) for k, v in b.items()}


def test_loss_metrics_and_grads_match_reference(mesh11, models):
    for aid, (jctx, jparams, ctx, params) in models.items():
        batch = _batch(ctx.arch)
        got_batch = pipeline.SyntheticLM(pipeline.DataConfig(
            vocab_size=ctx.arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
            seed=0)).batch(0)
        for k, v in batch.items():
            np.testing.assert_array_equal(got_batch[k].numpy(), v)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
            (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
                lambda p: jtransformer.loss_fn(p, jbatch, jctx),
                has_aux=True))(jparams)
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, m = transformer.loss_fn(params, got_batch, ctx)
            loss.backward()
            grads = [p.grad.detach().clone() for p in leaves]
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        close(loss, np.asarray(jloss))
        assert set(m) == set(jm), aid
        for k in m:
            close(m[k], jm[k])
        want = adamw.tree_leaves(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jgrads), ctx, "cpu"))
        assert len(want) == len(grads), aid
        for a, b in zip(grads, want):
            close(a, b)


RUN_KW = dict(seq_len=SEQ, global_batch=BATCH, warmup_steps=1, seed=0,
              aux_mode="none")


def _jax_steps(mesh, jctx, jparams, jrun, steps):
    """The reference's ``make_train_step`` stepped ``steps`` times from
    ``jparams`` on ``SyntheticLM`` batches 0, 1, ...: (params, metrics)."""
    from repro.optim import adamw as jadamw
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=jctx.arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0), jctx.arch)
    out = []
    with mesh, sharding.axis_rules(jmodel.default_rules(mesh)):
        jstep = jax.jit(jtrainer.make_train_step(jctx, jrun))
        # placed as the step's outputs are, so every step hits one compile
        jp, jo = jax.device_put((jparams, jadamw.init_state(jparams)),
                                NamedSharding(mesh, PartitionSpec()))
        for i in range(steps):
            jp, jo, m = jstep(jp, jo, data.batch(i))
            out.append(m)
    return jp, out


def test_trainer_steps_match_reference(mesh11, models):
    """Three steps of reduced ``internlm2_1_8b`` from copies of the
    fixture's weights (the port's AdamW updates in place): lr 3e-4 after a
    one-step warmup, no auxiliary loss."""
    jctx, jparams, ctx, _ = models["internlm2_1_8b"]
    _, want = _jax_steps(mesh11, jctx, jparams, JRunConfig(**RUN_KW), 3)
    got = trainer.train(ctx.arch, RunConfig(**RUN_KW), None, steps=3,
                        log_every=1, verbose=False,
                        params=params_from_numpy(
                            jax.tree_util.tree_map(np.array, jparams), ctx,
                            "cpu"),
                        device="cpu").metrics_history
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            close(g[k], w[k])


def test_grad_accumulation_equivalence(mesh11, models):
    """One step of reduced ``internlm2_1_8b`` with ``microbatch=2`` (two
    microbatches of 2 rows, float32 gradient accumulation) against the
    full-batch step from the same weights, as the reference's
    ``test_grad_accumulation_equivalence`` holds its own; both against the
    reference's steps at 1e-4."""
    jctx, jparams, ctx, _ = models["internlm2_1_8b"]
    b0 = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=ctx.arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0)).batch(0)
    got = {}
    for mb in (0, 2):
        run = RunConfig(**RUN_KW, microbatch=mb)
        params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                                   ctx, "cpu")
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        step = trainer.make_train_step(ctx, run)
        p1, _, m = step(params, adamw.init_state(params), b0)
        got[mb] = (float(m["loss"]), adamw.tree_leaves(p1)[0].detach())
        jp, (jm,) = _jax_steps(mesh11, jctx, jparams,
                               JRunConfig(**RUN_KW, microbatch=mb), 1)
        close(m["loss"], np.asarray(jm["loss"]))
        for a, b in zip(adamw.tree_leaves(p1), adamw.tree_leaves(
                params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  ctx, "cpu"))):
            close(a, b)
    assert got[0][0] == pytest.approx(got[2][0], rel=1e-4)
    np.testing.assert_allclose(got[0][1].numpy(), got[2][1].numpy(),
                               atol=1e-4, rtol=1e-3)


def prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def test_prefill_and_decode_match_reference(models):
    """A right-padded pack of 3 prompts in 4 rows prefilled (the KV caches
    written to rows [:S], ``pos`` the true lengths), then three greedy
    decode steps, for ``olmo_1b`` and ``granite_3_2b``."""
    for aid in ("olmo_1b", "granite_3_2b"):
        jctx, jparams, ctx, params = models[aid]
        ps = prompts(ctx.arch.vocab_size, [5, 11, 2], seed=0)
        cache_len = 24
        tok, lens = batching.pad_pack(ps, pack=4, buckets=(16,),
                                      device="cpu")
        jlg, jcache = jax.jit(jengine.make_prefill(
            jctx, with_cache=True, cache_len=cache_len))(
            jparams, {"tokens": jnp.asarray(tok.numpy()),
                      "lens": jnp.asarray(lens.numpy())})
        jstep = jax.jit(jengine.make_decode_step(jctx))
        lg, cache = engine.make_prefill(ctx, with_cache=True,
                                        cache_len=cache_len)(
            params, {"tokens": tok, "lens": lens})
        close(lg, jlg)
        step = engine.make_decode_step(ctx)
        for _ in range(3):
            nxt = np.asarray(jnp.argmax(jlg, axis=-1)).astype(
                np.int32)[:, None]
            np.testing.assert_array_equal(
                np.asarray(torch.argmax(lg, dim=-1))[:, None], nxt)
            jlg, jcache = jstep(jparams, jcache, jnp.asarray(nxt))
            lg, cache = step(params, cache, torch.from_numpy(nxt))
            jlg, lg = jlg[:, 0], lg[:, 0]
            close(lg, jlg)
        assert len(cache) == ctx.arch.num_layers
        for i, layer in enumerate(cache):
            jlayer = jax.tree_util.tree_map(
                lambda a, i=i: a[i], jcache["groups"]["sub0"]["mixer"])
            assert set(layer["mixer"]) == set(jlayer) == {"k", "v", "pos"}
            for k, v in jlayer.items():
                close(layer["mixer"][k], v)


SERVE_LENS, SERVE_BUDGETS = [3, 14, 7, 1, 16, 9], [4, 2, 6, 3, 5, 1]
SERVE_CFG = dict(num_slots=4, cache_len=24, prefill_pack=2,
                 prompt_buckets=(16,))


def test_serving_engine_greedy_tokens_match_reference(models):
    """Each reduced config through ``ServingEngine.run`` with
    ``use_flash=True``: every prefill attends through K5's entry (on CPU
    tensors its plain version), and the greedy tokens equal the reference
    engine's."""
    for aid, (jctx, jparams, ctx0, params) in models.items():
        ps = prompts(ctx0.arch.vocab_size, SERVE_LENS, seed=3)
        rep = jengine.ServingEngine(jparams, jctx,
                                    jengine.ServeConfig(**SERVE_CFG)).run(
            [JRequest(uid=i, tokens=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(ps, SERVE_BUDGETS))])
        ctx = dataclasses.replace(ctx0, use_flash=True)
        got = engine.ServingEngine(params, ctx,
                                   engine.ServeConfig(**SERVE_CFG)).run(
            [Request(uid=i, tokens=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(ps, SERVE_BUDGETS))])
        assert got.total_new_tokens == sum(SERVE_BUDGETS)
        for i in range(len(ps)):
            assert got.tokens_for(i) == [int(v) for v in rep.tokens_for(i)], \
                (aid, i)


def test_launchers_run_dense_on_cpu(capsys):
    from repro_torch.launch import serve, train
    for aid in ("olmo_1b", "internlm2_1_8b"):
        assert serve.main(["--arch", aid, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "4", "--steps",
                           "3", "--cache-len", "16", "--streams", "3"]) == 0
        assert "served 3 streams" in capsys.readouterr().out
        assert train.main(["--arch", aid, "--reduced", "--device", "cpu",
                           "--steps", "2", "--seq-len", "16",
                           "--global-batch", "2", "--log-every", "1"]) == 0
        assert "done: 2 steps on 1 rank(s)" in capsys.readouterr().out
