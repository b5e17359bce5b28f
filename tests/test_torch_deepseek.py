"""Parity of the port's DeepSeek-V2 models with the JAX package on the CPU.

- ``params_from_numpy`` carries the reference's DeepSeek parameters
  across (MLA leaves, ``kv_norm`` / ``q_norm`` as ``{"scale"}`` dicts, the
  shared experts, the dense first layer), and the port's own
  ``init_params`` makes the same tree.
- ``loss_fn`` of reduced ``deepseek_v2_lite_16b``, and of reduced
  ``deepseek_v2_236b`` with ``q_lora_rank=32`` (the low-rank query branch
  ``reduced()`` cuts to 0; the two reduced configs differ only in that
  branch) and 8 experts top-6 (the gate, capacity and combine that
  ``reduced()``'s top-2 of 4 would not reach):
  the loss, every metric and every gradient within rtol = atol = 1e-4,
  ``aux_mode="ta"``, ``dispatch="a2a"``, capacity factor 1.25 (tokens
  drop at top-2 of 4; top-6 of 8 fills an expert's 120 slots less often).
- ``train``: three trainer steps of the top-6-of-8 variant (lr 3e-4
  after a one-step warmup, TA at weight 1, as the card's
  ``train_dsv2_lite_d4`` runs them): every step's loss, nll, aux loss,
  dropped share and gradient norm within 1e-4.
- ``decode.prefill`` of a right-padded pack and three decode steps: the
  logits within 1e-4, the greedy tokens exact, the latent caches within
  1e-4; the slot operations on the MLA cache.
- ``ServingEngine.run``: exactly the reference engine's greedy tokens.
- ``launch.serve`` and ``launch.train`` with ``--arch
  deepseek_v2_lite_16b --reduced --device cpu``.

Both packages compute with the reference's ``init_params`` weights (as
numpy, through ``params_from_numpy``) on ``SyntheticLM`` batches; float32
at ``reduced()`` size (2 layers: the dense one and one MoE layer).  Each
reference model is built once, in a module fixture.

Run as a script (``PYTHONPATH=src python tests/test_torch_deepseek.py
[LR]``, LR 3e-4 by default) it prints the trainer steps of both packages
at DeepSeek-V2-Lite's router widths (d 2048, top-6 of 64 experts, 2
shared, seq 512, batch 4) with narrow experts (f 128), a 4096-token
vocabulary and 2 layers: whether the dropped share that rises on the card
at random init rises in the reference too.
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
from repro.serving import engine as jengine
from repro.serving.scheduler import Request as JRequest
from repro.training import trainer as jtrainer
from repro_torch.configs.base import RunConfig, get_config
from repro_torch.data import pipeline
from repro_torch.models import decode, model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.serving import batching, engine
from repro_torch.serving.scheduler import Request
from repro_torch.training import trainer

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 32, 4
# (arch id, q_lora_rank, (num_experts, top_k) or None for reduced()'s)
VARIANTS = {
    "lite": ("deepseek_v2_lite_16b", None, None),
    "236b_q32_top6": ("deepseek_v2_236b", 32, (8, 6)),
}


def close(got, want, **tol):
    got, want = (a.detach() if torch.is_tensor(a) else a
                 for a in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def variant(arch, q_lora_rank, experts):
    if q_lora_rank is not None:
        arch = dataclasses.replace(arch, mla=dataclasses.replace(
            arch.mla, q_lora_rank=q_lora_rank))
    if experts is not None:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, num_experts=experts[0], top_k=experts[1]))
    return arch


def build(mesh11, name, **kw):
    """(jax ctx, jax params, port ctx, port params) of one variant, the
    weights the reference's ``init_params`` from key 0."""
    aid, q_lora_rank, experts = VARIANTS[name]
    jarch = variant(jax_get_config(aid).reduced(), q_lora_rank, experts)
    arch = variant(get_config(aid).reduced(), q_lora_rank, experts)
    jctx = jmodel.build_ctx(jarch, mesh11, seq_len=SEQ, global_batch=BATCH,
                            **kw)
    ctx = model.build_ctx(arch, seq_len=SEQ, global_batch=BATCH,
                          device="cpu", **kw)
    # under one jit: a third of the eager init's time, one compilation
    # instead of one a leaf
    with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
        jparams = jax.jit(lambda key: jmodel.init_params(key, jctx))(
            jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               ctx, "cpu")
    return jctx, jparams, ctx, params


@pytest.fixture(scope="module")
def models(mesh11):
    return {name: build(mesh11, name, aux_mode="ta") for name in VARIANTS}


def shapes(tree, path=()):
    if isinstance(tree, dict):
        return sum((shapes(tree[k], path + (k,)) for k in sorted(tree)), [])
    if isinstance(tree, list):
        return sum((shapes(v, path + (i,)) for i, v in enumerate(tree)), [])
    return [(path, tuple(tree.shape), tree.dtype)]


def test_converted_params_match_the_ports_own_init(models):
    """Both query branches: the full-rank one of DeepSeek-V2-Lite and the
    low-rank one of 236B."""
    for name in VARIANTS:
        _, _, ctx, params = models[name]
        own = model.init_params(ctx, torch.Generator().manual_seed(0), "cpu")
        assert shapes(params) == shapes(own)
        subs = transformer.layer_list(ctx.arch)
        assert [(s.mixer, s.ffn) for s in subs] == [("mla", "mlp"),
                                                     ("mla", "moe")]
        mixer = params["layers"][0]["mixer"]
        assert set(mixer["kv_norm"]) == {"scale"}
        assert ("q_norm" in mixer) == (name == "236b_q32_top6")
        ffn = params["layers"][1]["ffn"]
        assert {"shared_in", "shared_gate", "shared_out"} <= set(ffn)
        assert ffn["shared_in"].shape[1] == ctx.arch.moe.d_ff_expert * \
            ctx.arch.moe.num_shared_experts
        assert set(params["layers"][0]["ffn"]) == {"w_in", "w_gate",
                                                   "w_out"}


def _batch(arch):
    b = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0)).batch(0)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_metrics_and_grads_match_reference(mesh11, models, name):
    jctx, jparams, ctx, params = models[name]
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
    assert set(m) == set(jm)
    for k in m:
        close(m[k], jm[k])
    if VARIANTS[name][2] is None:          # top-2 of 4 at factor 1.25
        assert float(m["dropped"]) > 0
    want = adamw.tree_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), ctx, "cpu"))
    assert len(want) == len(grads)
    for a, b in zip(grads, want):
        close(a, b)


def trainer_histories(mesh, jctx, jparams, arch, seq, batch, steps=3,
                      lr=3e-4):
    """Both packages' training for ``steps`` steps from the weights
    ``jparams`` (the reference's ``init_params`` from key 0) at ``jctx``
    (built for ``seq`` x ``batch``, TA): the reference's
    ``make_train_step`` stepped as its ``train`` steps it, and the port's
    ``train``; ``lr`` after a one-step warmup and the TA aux loss at weight
    1.  Returns (port, reference) metric histories."""
    from repro.optim import adamw as jadamw
    run_kw = dict(seq_len=seq, global_batch=batch, warmup_steps=1, seed=0,
                  aux_mode="ta", learning_rate=lr)
    jrun = JRunConfig(**run_kw)
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=jctx.arch.vocab_size, seq_len=jrun.seq_len,
        global_batch=jrun.global_batch, seed=jrun.seed), jctx.arch)
    want = []
    with mesh, sharding.axis_rules(jmodel.default_rules(mesh)):
        jstep = jax.jit(jtrainer.make_train_step(jctx, jrun))
        jp, jo = jparams, jadamw.init_state(jparams)
        for i in range(steps):
            jp, jo, m = jstep(jp, jo, data.batch(i))
            want.append(m)
    ctx = model.build_ctx(arch, seq_len=jrun.seq_len,
                          global_batch=jrun.global_batch, aux_mode="ta",
                          device="cpu")
    got = trainer.train(arch, RunConfig(**run_kw), None, steps=steps,
                        log_every=1, verbose=False,
                        params=params_from_numpy(
                            jax.tree_util.tree_map(np.array, jparams), ctx,
                            "cpu"),
                        device="cpu")
    return got.metrics_history, want


def test_trainer_steps_match_reference(mesh11, models):
    """The top-6-of-8 variant: the gate, capacity and combine over steps
    whose routing moves, from copies of the fixture's weights (the port's
    AdamW updates in place)."""
    jctx, jparams, ctx, _ = models["236b_q32_top6"]
    got, want = trainer_histories(mesh11, jctx, jparams, ctx.arch, SEQ,
                                   BATCH)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("loss", "nll", "aux", "dropped", "grad_norm"):
            close(g[k], w[k])


def prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def test_prefill_and_decode_match_reference(models):
    """A right-padded pack prefilled (the MLA caches written to rows [:S],
    ``pos`` the true lengths), then three greedy decode steps against the
    compressed caches, on the low-rank query branch with top-6 of 8
    experts through the gather path (the serving test below runs
    DeepSeek-V2-Lite's full-rank branch)."""
    jctx, jparams, ctx, params = models["236b_q32_top6"]
    ps = prompts(ctx.arch.vocab_size, [5, 11, 2], seed=0)
    cache_len = 24
    tok, lens = batching.pad_pack(ps, pack=4, buckets=(16,), device="cpu")
    jtok, jlens = jnp.asarray(tok.numpy()), jnp.asarray(lens.numpy())
    jlg, jcache = jax.jit(jengine.make_prefill(
        jctx, with_cache=True, cache_len=cache_len))(
        jparams, {"tokens": jtok, "lens": jlens})
    jstep = jax.jit(jengine.make_decode_step(jctx))
    lg, cache = engine.make_prefill(ctx, with_cache=True,
                                    cache_len=cache_len)(
        params, {"tokens": tok, "lens": lens})
    close(lg, jlg)
    step = engine.make_decode_step(ctx)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(
            np.asarray(torch.argmax(lg, dim=-1))[:, None], nxt)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(nxt))
        lg, cache = step(params, cache, torch.from_numpy(nxt))
        jlg, lg = jlg[:, 0], lg[:, 0]
        close(lg, jlg)
    want = [jcache["prefix0"]["mixer"]] + [
        jax.tree_util.tree_map(lambda a: a[0],
                               jcache["groups"]["sub0"]["mixer"])]
    for layer, jlayer in zip(cache, want):
        assert set(layer["mixer"]) == set(jlayer) == {"c_kv", "k_rope",
                                                       "pos"}
        for k, v in jlayer.items():
            close(layer["mixer"][k], v)


def test_slot_ops_hold_for_the_mla_cache(models):
    _, _, ctx, _ = models["lite"]
    kv = batching.SlotKVCache(ctx, num_slots=3, cache_len=8)
    src = decode.init_cache(ctx, 2, 6, device="cpu")
    for i, layer in enumerate(src):
        layer["mixer"]["c_kv"].fill_(1.0 + i)
        layer["mixer"]["k_rope"].fill_(-2.0)
        layer["mixer"]["pos"].fill_(5)
    kv.insert(src, np.asarray([2, 3]))            # id 3 == num_slots: dropped
    np.testing.assert_array_equal(kv.positions(), [0, 0, 5])
    for i, layer in enumerate(kv.cache):
        c = layer["mixer"]
        assert tuple(c["c_kv"].shape) == (3, 8, ctx.arch.mla.kv_lora_rank)
        assert tuple(c["k_rope"].shape) == (3, 8, ctx.arch.mla.qk_rope_dim)
        assert float(c["c_kv"][2, :6].min()) == 1.0 + i
        assert float(c["c_kv"][2, 6:].abs().max()) == 0.0   # past the source
        assert float(c["k_rope"][2, :6].max()) == -2.0
        assert float(c["c_kv"][:2].abs().max()) == 0.0
    kv.evict([2])
    np.testing.assert_array_equal(kv.positions(), [0, 0, 0])
    for layer in kv.cache:
        for leaf in layer["mixer"].values():
            assert float(leaf.abs().max()) == 0.0


SERVE_LENS, SERVE_BUDGETS = [3, 14, 7, 1, 16, 9], [4, 2, 6, 3, 5, 1]
SERVE_CFG = dict(num_slots=4, cache_len=24, prefill_pack=2,
                 prompt_buckets=(16,))


@pytest.fixture(scope="module")
def jax_served(models):
    jctx, jparams, ctx, _ = models["lite"]
    ps = prompts(ctx.arch.vocab_size, SERVE_LENS, seed=3)
    rep = jengine.ServingEngine(jparams, jctx,
                                jengine.ServeConfig(**SERVE_CFG)).run(
        [JRequest(uid=i, tokens=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(ps, SERVE_BUDGETS))])
    return ps, [[int(v) for v in rep.tokens_for(i)] for i in range(len(ps))]


def test_serving_engine_greedy_tokens_match_reference(models, jax_served):
    """Through the unfused gather branch (auto on the CPU) and the fused
    one (``use_pallas=True``: K4's entry, its plain version on the CPU),
    with ``use_flash=True``, which MLA layers do not read."""
    _, _, ctx0, params = models["lite"]
    ps, want = jax_served
    for use_pallas in (None, True):
        ctx = dataclasses.replace(ctx0, use_pallas=use_pallas,
                                  use_flash=True)
        rep = engine.ServingEngine(params, ctx,
                                   engine.ServeConfig(**SERVE_CFG)).run(
            [Request(uid=i, tokens=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(ps, SERVE_BUDGETS))])
        assert rep.total_new_tokens == sum(SERVE_BUDGETS)
        for i in range(len(ps)):
            assert rep.tokens_for(i) == want[i], (use_pallas, i)


def test_launchers_run_deepseek_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", "deepseek_v2_lite_16b", "--reduced",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "4", "--steps", "3", "--cache-len", "16",
                       "--streams", "3"]) == 0
    assert "served 3 streams" in capsys.readouterr().out
    assert train.main(["--arch", "deepseek_v2_lite_16b", "--reduced",
                       "--device", "cpu", "--steps", "2", "--seq-len", "16",
                       "--global-batch", "2", "--log-every", "1"]) == 0
    assert "done: 2 steps on 1 rank(s)" in capsys.readouterr().out


def _router_width_steps(lr):
    """``trainer_histories`` at DeepSeek-V2-Lite's router widths (see the
    module docstring) and learning rate ``lr``, printed a step a line for
    both packages."""
    from repro.compat import make_mesh

    def wide(a):
        r = a.reduced()
        return dataclasses.replace(
            r, d_model=2048, d_ff=512, vocab_size=4096,
            moe=dataclasses.replace(
                r.moe, num_experts=64, top_k=6, d_ff_expert=128,
                num_shared_experts=a.moe.num_shared_experts))

    mesh = make_mesh((1, 1), ("data", "model"))
    jarch = wide(jax_get_config("deepseek_v2_lite_16b"))
    arch = wide(get_config("deepseek_v2_lite_16b"))
    jctx = jmodel.build_ctx(jarch, mesh, seq_len=512, global_batch=4,
                            aux_mode="ta")
    with mesh, sharding.axis_rules(jmodel.default_rules(mesh)):
        jparams = jmodel.init_params(jax.random.PRNGKey(0), jctx)
    got, want = trainer_histories(mesh, jctx, jparams, arch, 512, 4, lr=lr)
    print(f"lr {lr}")
    for i, (g, w) in enumerate(zip(got, want)):
        print(f"step {i}: " + ", ".join(
            f"{k} {float(g[k]):.5f} (reference {float(w[k]):.5f})"
            for k in ("loss", "nll", "aux", "dropped")))


if __name__ == "__main__":
    import sys
    _router_width_steps(float(sys.argv[1]) if len(sys.argv) > 1 else 3e-4)
