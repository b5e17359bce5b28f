"""Tensor parallelism: the port on a (data 2, model 2) world against the
JAX package on a (data 2, model 2) mesh of forced host devices.

One JAX subprocess on 4 forced host devices builds each model on the
``("data", "model")`` mesh with ``default_rules`` (its parameters
sharded by ``param_spec_rules``, GSPMD placing the collectives) and
computes, for reduced ``gpt3_medium_moe`` (4 experts, EP 2 over
``data``, each expert's width over ``model``), reduced ``minitron_4b``
and an odd variant of it (vocabulary 511, which 2 does not divide, so
its table stays whole, and 1 KV head, so its attention stays whole):

- the logits of ``forward``;
- ``loss_fn`` and every gradient;
- 3 ``trainer.train`` steps (gpt3 and Minitron);
- greedy ``generate`` and ``ServingEngine.run`` tokens.

Beside it, as soon as it has written the weights and batches
(``torch_world_reference``), 4 CPU processes of the port, joined over
gloo (``launch.mesh.spawn(..., model=2)``), run the same from the same
weights, each with its slices (``convert.params_from_numpy`` ->
``model.shard_params``): attention split by heads where 2 divides the
query and KV heads, the dense and expert FFNs by width, the embedding by
vocabulary rows, with the vocab-parallel loss.  gpt3's loss runs with the
kernels wanted (their plain versions) and not; serving goes through the
gather path, fused (K4's plain version) and not.  The two model ranks of
each data rank must route alike: the digests of every gate's top-k picks
are equal.

Tolerance: rtol = atol = 1e-4 (float32; sums in another order and split
over the model axis); greedy tokens exact.
"""

import dataclasses
import hashlib
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SIZES, MODEL = (2,), 2
SEQ, BATCH, STEPS = 16, 4, 3
TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = ("gpt3", "minitron", "odd")
ARCHS = {"gpt3": ("gpt3_medium_moe", {}),
         "minitron": ("minitron_4b", {}),
         "odd": ("minitron_4b", {"vocab_size": 511, "num_kv_heads": 1})}
TRAINED = ("gpt3", "minitron")
SERVE = dict(num_slots=4, cache_len=32, prefill_pack=2,
             prompt_buckets=(8, 16))
PROMPT_LENS = (3, 8, 12, 5, 1, 9)
BUDGETS = (4, 6, 3, 5, 2, 4)
GEN_PROMPT, GEN_STEPS, GEN_CACHE = 6, 5, 16

REFERENCE = f"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import RunConfig, get_config
from repro.models import model, transformer
from repro.serving import engine
from repro.serving.scheduler import Request
from repro.training import trainer

mesh = make_mesh({SIZES + (MODEL,)}, ("data", "model"))
rules = model.default_rules(mesh)
archs = {{k: dataclasses.replace(get_config(aid).reduced(), **kw)
         for k, (aid, kw) in {ARCHS}.items()}}
rng = np.random.default_rng(11)
inputs, built = {{}}, {{}}
for k, arch in archs.items():
    ctx = model.build_ctx(arch, mesh, seq_len={SEQ}, global_batch={BATCH},
                          aux_mode="ta")
    with mesh, sharding.axis_rules(rules):
        params = model.init_params(jax.random.PRNGKey(0), ctx, rules=rules)
    toks = rng.integers(0, arch.vocab_size, size=({BATCH}, {SEQ} + 1))
    batch = {{"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "loss_mask": (rng.random(({BATCH}, {SEQ})) > 0.1).astype(
                 np.float32)}}
    prompts = [rng.integers(0, arch.vocab_size, size=n).tolist()
               for n in {PROMPT_LENS}]
    gen = rng.integers(0, arch.vocab_size,
                       size=({BATCH}, {GEN_PROMPT})).astype(np.int32)
    inputs[k] = {{"params": jax.tree_util.tree_map(np.asarray, params),
                 "batch": batch, "prompts": prompts, "gen": gen}}
    built[k] = (ctx, params)
dump_inputs(inputs)
out = {{}}
for k, arch in archs.items():
    ctx, params = built[k]
    jb = {{kk: jnp.asarray(v) for kk, v in inputs[k]["batch"].items()}}
    with mesh, sharding.axis_rules(rules):
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p: transformer.loss_fn(p, jb, ctx), has_aux=True))(params)
        logits, _ = jax.jit(lambda p: transformer.forward(p, jb, ctx))(params)
    res = {{"loss": np.asarray(loss),
           "metrics": {{kk: np.asarray(v) for kk, v in m.items()}},
           "grads": jax.tree_util.tree_map(np.asarray, g),
           "logits": np.asarray(logits)}}
    if k in {TRAINED}:
        res["history"] = trainer.train(
            arch, RunConfig(seq_len={SEQ}, global_batch={BATCH},
                            warmup_steps=1, aux_mode="ta", seed=0), mesh,
            steps={STEPS}, log_every=1, verbose=False).metrics_history
    sctx = model.build_ctx(arch, mesh, seq_len={SERVE["cache_len"]},
                           global_batch={SERVE["num_slots"]},
                           aux_mode="none")
    with mesh, sharding.axis_rules(rules):
        reqs = [Request(uid=i, tokens=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(inputs[k]["prompts"],
                                               {BUDGETS}))]
        rep = engine.ServingEngine(params, sctx,
                                   engine.ServeConfig(**{SERVE})).run(reqs)
        gen = engine.generate(params, sctx, jnp.asarray(inputs[k]["gen"]),
                              steps={GEN_STEPS}, cache_len={GEN_CACHE})
    res["served"] = {{i: rep.tokens_for(i) for i in range(len(reqs))}}
    res["generated"] = np.asarray(gen.tokens)
    out[k] = res
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _arch(key):
    from repro_torch.configs.base import get_config
    aid, kw = ARCHS[key]
    return dataclasses.replace(get_config(aid).reduced(), **kw)


def _picks_recorder(log):
    """Wraps ``gating.gate_forward`` so every top-k pick lands in
    ``log``; returns the original to restore."""
    from repro_torch.core import gating
    orig = gating.gate_forward

    def rec(*a, **kw):
        out = orig(*a, **kw)
        log.append(out["topk_idx"].detach().to(torch.int64).numpy().tobytes())
        return out
    gating.gate_forward = rec
    return orig


def _full_grads(world, params, ctx):
    """The synced gradient tree, gathered over the model axis and, for the
    expert leaves, over the EP axis: the global tree on every rank."""
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    grads, _ = trainer.sync_grads(params, ctx)
    full = model.gather_params(grads, ctx)
    mask = trainer.expert_mask(params, ctx)
    leaves = [world.all_gather(t.contiguous(), ctx.ep.axis_names)
              if e and world.size > 1 else t
              for t, e in zip(adamw.tree_leaves(full), mask)]
    it = iter(leaves)
    return adamw.tree_map(lambda _: next(it).numpy(), full)


def _rank_main(world, ref_path, out_dir):
    torch.set_num_threads(1)
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.configs.base import RunConfig
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import Request
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    per = BATCH // world.size
    rows = slice(world.rank * per, (world.rank + 1) * per)
    out = {"rank": world.rank, "model_coord": world.model_coord}
    for key in VARIANTS:
        arch, inp = _arch(key), ref[key]
        res = out[key] = {}
        batch = {k: torch.from_numpy(v[rows].copy())
                 for k, v in inp["batch"].items()}
        for use_pallas in ((False, True) if key == "gpt3" else (False,)):
            ctx = model.build_ctx(arch, world, seq_len=SEQ,
                                  global_batch=BATCH, aux_mode="ta",
                                  use_pallas=use_pallas, device="cpu")
            params = params_from_numpy(inp["params"], ctx, "cpu")
            for p in adamw.tree_leaves(params):
                p.requires_grad_(True)
            picks = []
            orig = _picks_recorder(picks)
            try:
                loss, m = transformer.loss_fn(params, batch, ctx)
                (loss / world.size).backward()
            finally:
                from repro_torch.core import gating
                gating.gate_forward = orig
            res["loss", use_pallas] = world.mean(m)
            res["grads", use_pallas] = _full_grads(world, params, ctx)
            res["picks", use_pallas] = hashlib.sha256(
                b"".join(picks)).hexdigest()
            res["n_picks", use_pallas] = len(picks)
        with torch.no_grad():
            logits, _ = transformer.forward(params, batch, ctx)
        res["logits"] = logits.numpy()
        if key in TRAINED:
            run = RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                            aux_mode="ta", seed=0)
            res["history"] = trainer.train(
                arch, run, world, steps=STEPS, log_every=1, verbose=False,
                params=params_from_numpy(inp["params"], ctx, "cpu"),
                device="cpu").metrics_history
        for use_pallas in (False, True):
            sctx = model.build_ctx(arch, world, seq_len=SERVE["cache_len"],
                                   global_batch=SERVE["num_slots"],
                                   aux_mode="none", use_pallas=use_pallas,
                                   device="cpu")
            sparams = params_from_numpy(inp["params"], sctx, "cpu")
            reqs = [Request(uid=i, tokens=p, max_new_tokens=n)
                    for i, (p, n) in enumerate(zip(inp["prompts"],
                                                   BUDGETS))]
            rep = engine.ServingEngine(sparams, sctx,
                                       engine.ServeConfig(**SERVE)).run(reqs)
            res["served", use_pallas] = {i: rep.tokens_for(i)
                                         for i in range(len(reqs))}
            res["generated", use_pallas] = engine.generate(
                sparams, sctx, torch.from_numpy(inp["gen"].copy()),
                steps=GEN_STEPS, cache_len=GEN_CACHE).tokens.numpy()
    with open(os.path.join(out_dir, f"rank{world.process_rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [process 0..3 results]) — one JAX subprocess
    and, beside it once it has made the weights and batches, one
    4-process (data 2, model 2) gloo world of the port."""
    from repro_torch.launch import mesh
    from torch_world_reference import run_beside_world
    tmp = tmp_path_factory.mktemp("tensor_parallel")
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


def _ref_tree(key, tree):
    """A reference tree (stacked, every expert) in the port's layout."""
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    ctx = model.build_ctx(_arch(key), seq_len=SEQ, global_batch=BATCH,
                          aux_mode="ta", device="cpu")
    return params_from_numpy(tree, ctx, "cpu")


def test_logits_match_reference(runs):
    """``forward``'s logits, every data rank's rows, on both model ranks
    (bit-equal between them: the vocab shards are all-gathered)."""
    ref, ranks = runs
    for key in VARIANTS:
        for a, b in zip(ranks[0::2], ranks[1::2]):
            assert np.array_equal(a[key]["logits"], b[key]["logits"])
        got = np.concatenate([r[key]["logits"] for r in ranks[0::2]])
        close(got, ref[key]["logits"])


def test_loss_and_every_gradient_match_reference(runs):
    """The world-mean loss and metrics, and every gradient (synced,
    gathered over the model axis and the experts' EP axis): the norms,
    the gate, attention whether split or whole, the FFNs, the table."""
    from repro_torch.optim import adamw
    ref, ranks = runs
    for key in VARIANTS:
        want = ref[key]
        wgrads = adamw.tree_leaves(_ref_tree(key, want["grads"]))
        for out in ranks:
            for up in ((False, True) if key == "gpt3" else (False,)):
                m = out[key]["loss", up]
                close(m["loss"], want["loss"])
                for k in want["metrics"]:
                    close(m[k], want["metrics"][k])
                got = adamw.tree_leaves(out[key]["grads", up])
                assert len(got) == len(wgrads)
                for g, w in zip(got, wgrads):
                    close(g, w.numpy())


def test_model_ranks_route_alike(runs):
    """Both model ranks of a data rank pick the same experts in every
    layer (their gate inputs are the same bits after each all-reduce):
    the digests of all the top-k picks of the loss's forward are equal;
    the two data ranks' differ (their tokens do)."""
    _, ranks = runs
    for up in (False, True):
        digests = [r["gpt3"]["picks", up] for r in ranks]
        assert ranks[0]["gpt3"]["n_picks", up] == _arch("gpt3").num_layers
        assert digests[0] == digests[1] and digests[2] == digests[3]
        assert digests[0] != digests[2]


def test_trainer_steps_match_reference(runs):
    """3 ``trainer.train`` steps from the reference's weights: every
    logged metric, the gradient norm included (model-sliced leaves'
    squares summed over the model axis, replicated leaves once)."""
    ref, ranks = runs
    for key in TRAINED:
        want = ref[key]["history"]
        for out in ranks:
            got = out[key]["history"]
            assert len(got) == len(want) == STEPS
            for g, w in zip(got, want):
                for k in ("loss", "nll", "aux", "grad_norm", "lr"):
                    close(g[k], w[k])


def test_greedy_tokens_exact(runs):
    """``ServingEngine.run`` and ``generate``, greedy, through the gather
    path with the kernels wanted (fused) and not: every rank's tokens are
    the reference's, exactly."""
    ref, ranks = runs
    for key in VARIANTS:
        for out in ranks:
            for up in (False, True):
                assert out[key]["served", up] == ref[key]["served"], key
                np.testing.assert_array_equal(out[key]["generated", up],
                                              ref[key]["generated"])


def test_launchers_take_a_model_axis(capfd):
    """``launch/serve.py`` and ``launch/train.py`` with ``--mesh-shape
    2,2``: four gloo ranks (data 2 x model 2) serve the streams and take
    the steps, process 0 reports; a model axis that a split width does
    not divide (reduced Jamba's Mamba inner dim 512 over 3) is refused by
    that width's name."""
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", "gpt3_medium_moe", "--reduced", "--device",
                       "cpu", "--mesh-shape", "2,2", "--batch", "4",
                       "--prompt-len", "4", "--steps", "3", "--cache-len",
                       "16", "--streams", "4"]) == 0
    assert train.main(["--arch", "minitron_4b", "--reduced", "--device",
                       "cpu", "--mesh-shape", "2,2", "--steps", "2",
                       "--seq-len", "16", "--global-batch", "4",
                       "--log-every", "1"]) == 0
    out = capfd.readouterr().out
    assert out.count("served 4 streams") == 1
    assert "done: 2 steps on 4 rank(s)" in out
    with pytest.raises(SystemExit):
        train.main(["--arch", "jamba_v0_1_52b", "--reduced", "--device",
                    "cpu", "--mesh-shape", "1,3"])
    assert "Mamba" in capfd.readouterr().err
