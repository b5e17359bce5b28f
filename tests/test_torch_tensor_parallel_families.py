"""Tensor parallelism of the families with mixers of their own on a
(data 2, model 2) world of the port against the JAX package on a (data
2, model 2) mesh of forced host devices.

One JAX subprocess on 4 forced host devices builds each model on the
``("data", "model")`` mesh with ``default_rules`` (its parameters
sharded by ``param_spec_rules``, GSPMD placing the collectives) and
computes the logits of ``forward``, ``loss_fn`` with every gradient, and
greedy ``generate`` tokens, for reduced

- DeepSeek-V2-Lite (MLA in both layers, a dense first layer, then MoE
  with a shared expert: 4 experts, EP 2 over ``data``);
- Jamba cut to one group of 2 (a Mamba layer with a dense FFN, then an
  attention layer with the MoE FFN);
- xLSTM cut to one group of 2 (an mLSTM block, then an sLSTM block);
- Whisper cut to one encoder and one decoder layer (self- and
  cross-attention), with frame embeddings;
- InternVL2 cut to one layer, with patch embeddings through the
  projector.

Beside it, as soon as it has written the weights and batches
(``torch_world_reference``), 4 CPU processes of the port, joined over
gloo (``launch.mesh.spawn(..., model=2)``), run the same from the same
weights, each with its slices (``convert.params_from_numpy`` ->
``model.shard_params``): MLA and the xLSTM mixers by heads, Mamba by its
inner channels, Whisper's encoder and cross-attention by heads,
InternVL2's projector by its width.  The two model ranks of each data
rank must route alike: the digests of every gate's top-k picks are
equal.  The launchers take a family on a model axis too.

Tolerance: rtol = atol = 1e-4 (float32; sums in another order and split
over the model axis); xLSTM's gradients at 1e-4 of each tensor's largest
entry (reduced xLSTM is ill-conditioned in float32, as in
``test_torch_xlstm.py``); greedy tokens exact.
"""

import dataclasses
import hashlib
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SIZES, MODEL = (2,), 2
SEQ, BATCH = 16, 4
TOL = dict(rtol=1e-4, atol=1e-4)
#: (config id, fields replaced in its ``reduced()``; "moe_period" goes
#: into the MoE config): the fewest layers that hold each sublayer kind
ARCHS = {"dsv2": ("deepseek_v2_lite_16b", {}),
         "jamba": ("jamba_v0_1_52b", {"num_layers": 2, "attn_every": 2,
                                      "attn_offset": 1, "moe_period": 2}),
         "xlstm": ("xlstm_350m", {"num_layers": 2, "slstm_every": 2}),
         "whisper": ("whisper_tiny", {"num_layers": 1, "enc_layers": 1}),
         "vlm": ("internvl2_26b", {"num_layers": 1})}
VARIANTS = tuple(ARCHS)
MOE = ("dsv2", "jamba")
GEN_PROMPT, GEN_STEPS, GEN_CACHE = 20, 4, 32

REFERENCE = f"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import get_config
from repro.models import model, transformer, vlm, whisper
from repro.serving import engine

mesh = make_mesh({SIZES + (MODEL,)}, ("data", "model"))
rules = model.default_rules(mesh)


def arch_of(aid, kw):
    base = get_config(aid).reduced()
    kw = dict(kw)
    if "moe_period" in kw:
        kw["moe"] = dataclasses.replace(base.moe,
                                        moe_period=kw.pop("moe_period"))
    return dataclasses.replace(base, **kw)


def frontend(arch, rng, rows):
    if arch.frontend == "vision":
        return rng.standard_normal(vlm.patch_shape(rows, arch)).astype(
            np.float32)
    if arch.frontend:
        return rng.standard_normal(whisper.frame_shape(rows, arch)).astype(
            np.float32)
    return None


archs = {{k: arch_of(aid, kw) for k, (aid, kw) in {ARCHS}.items()}}
rng = np.random.default_rng(7)
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
    fe = frontend(arch, rng, {BATCH})
    if fe is not None:
        batch["frontend"] = fe
    gen = rng.integers(0, arch.vocab_size,
                       size=({BATCH}, {GEN_PROMPT})).astype(np.int32)
    inputs[k] = {{"params": jax.tree_util.tree_map(np.asarray, params),
                 "batch": batch, "gen": gen}}
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
    sctx = model.build_ctx(arch, mesh, seq_len={GEN_CACHE},
                           global_batch={BATCH}, aux_mode="none")
    fe = inputs[k]["batch"].get("frontend")
    with mesh, sharding.axis_rules(rules):
        gen = engine.generate(params, sctx, jnp.asarray(inputs[k]["gen"]),
                              steps={GEN_STEPS}, cache_len={GEN_CACHE},
                              frontend=None if fe is None else jnp.asarray(fe))
    res["generated"] = np.asarray(gen.tokens)
    out[k] = res
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _arch(key):
    from repro_torch.configs.base import get_config
    aid, kw = ARCHS[key]
    base = get_config(aid).reduced()
    kw = dict(kw)
    if "moe_period" in kw:
        kw["moe"] = dataclasses.replace(base.moe,
                                        moe_period=kw.pop("moe_period"))
    return dataclasses.replace(base, **kw)


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
              if e and ctx.ep is not None and world.size > 1 else t
              for t, e in zip(adamw.tree_leaves(full), mask)]
    it = iter(leaves)
    return adamw.tree_map(lambda _: next(it).numpy(), full)


def _rank_main(world, ref_path, out_dir):
    torch.set_num_threads(1)
    from repro_torch.core import gating
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.serving import engine

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
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              aux_mode="ta", device="cpu")
        params = params_from_numpy(inp["params"], ctx, "cpu")
        res["param_numel"] = sum(t.numel() for t in adamw.tree_leaves(params))
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        picks = []
        orig = _picks_recorder(picks)
        try:
            loss, m = transformer.loss_fn(params, batch, ctx)
            (loss / world.size).backward()
        finally:
            gating.gate_forward = orig
        res["loss"] = world.mean(m)
        res["grads"] = _full_grads(world, params, ctx)
        res["picks"] = hashlib.sha256(b"".join(picks)).hexdigest()
        res["n_picks"] = len(picks)
        with torch.no_grad():
            logits, _ = transformer.forward(params, batch, ctx)
        res["logits"] = logits.numpy()
        sctx = model.build_ctx(arch, world, seq_len=GEN_CACHE,
                               global_batch=BATCH, aux_mode="none",
                               device="cpu")
        sparams = params_from_numpy(inp["params"], sctx, "cpu")
        fe = inp["batch"].get("frontend")
        res["generated"] = engine.generate(
            sparams, sctx, torch.from_numpy(inp["gen"].copy()),
            steps=GEN_STEPS, cache_len=GEN_CACHE,
            frontend=None if fe is None else torch.from_numpy(fe.copy())
        ).tokens.numpy()
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
    tmp = tmp_path_factory.mktemp("tensor_parallel_families")
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
    """``forward``'s logits of every family, every data rank's rows, on
    both model ranks (bit-equal between them)."""
    ref, ranks = runs
    for key in VARIANTS:
        for a, b in zip(ranks[0::2], ranks[1::2]):
            assert np.array_equal(a[key]["logits"], b[key]["logits"]), key
        got = np.concatenate([r[key]["logits"] for r in ranks[0::2]])
        close(got, ref[key]["logits"])


def test_loss_and_every_gradient_match_reference(runs):
    """The world-mean loss and metrics, and every gradient (synced,
    gathered over the model axis, stripe by stripe, and the experts' EP
    axis): MLA's heads and its whole latent leaves, Mamba's channels and
    its row-parallel ``w_x_dbc``, both xLSTM mixers (at 1e-4 of each
    tensor's largest entry), Whisper's encoder and cross-attention,
    InternVL2's projector."""
    from repro_torch.optim import adamw
    ref, ranks = runs
    for key in VARIANTS:
        want = ref[key]
        wgrads = adamw.tree_leaves(_ref_tree(key, want["grads"]))
        for out in ranks:
            m = out[key]["loss"]
            close(m["loss"], want["loss"])
            for k in want["metrics"]:
                close(m[k], want["metrics"][k])
            got = adamw.tree_leaves(out[key]["grads"])
            assert len(got) == len(wgrads), key
            for g, w in zip(got, wgrads):
                w = w.numpy()
                if key == "xlstm":
                    scale = max(float(np.max(np.abs(w))), 1e-30)
                    close(g / scale, w / scale, rtol=0, atol=1e-4)
                else:
                    close(g, w)


def test_model_ranks_route_alike(runs):
    """Both model ranks of a data rank pick the same experts in every MoE
    layer of DeepSeek-V2-Lite and Jamba (their gate inputs are the same
    bits after MLA's and Mamba's reductions): the digests of the loss's
    top-k picks are equal; the two data ranks' differ."""
    _, ranks = runs
    for key in MOE:
        digests = [r[key]["picks"] for r in ranks]
        assert ranks[0][key]["n_picks"] == 1, key
        assert digests[0] == digests[1] and digests[2] == digests[3], key
        assert digests[0] != digests[2], key


def test_greedy_tokens_exact(runs):
    """``generate`` on the model axis, greedy: MLA's absorbed decode on
    the whole latent cache, the scan prefills of Jamba, xLSTM and Whisper
    with each rank's share of the states and cross K/V, InternVL2's
    patch splice; every rank's tokens are the reference's exactly."""
    ref, ranks = runs
    for key in VARIANTS:
        for out in ranks:
            np.testing.assert_array_equal(out[key]["generated"],
                                          ref[key]["generated"], key)


def test_parameters_a_rank_about_half(runs):
    """A rank holds 0.4-0.6 of the one-rank parameters: half of each
    leaf split over the model axis, the leaves kept whole (norms, MLA's
    latent, the mLSTM's ``xu`` stripe) whole, and the MoE families half
    their experts besides (EP 2); every rank holds the same count."""
    from repro_torch.models import model
    from repro_torch.optim import adamw
    _, ranks = runs
    for key in VARIANTS:
        one = model.build_ctx(_arch(key), seq_len=SEQ, global_batch=BATCH,
                              device="cpu")
        full = sum(t.numel() for t in adamw.tree_leaves(
            model.full_abstract_params(one)))
        counts = [r[key]["param_numel"] for r in ranks]
        assert counts[0] == counts[1] == counts[2] == counts[3], key
        assert full * 0.4 < counts[0] < full * 0.6, (key, counts[0], full)


def test_launchers_take_the_families(capfd):
    """``launch/serve.py`` and ``launch/train.py`` on ``--mesh-shape 1,2``
    (a model axis of 2): reduced xLSTM serves its streams through the
    scan prefill and reduced Whisper takes its steps, process 0
    reports."""
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", "xlstm_350m", "--reduced", "--device",
                       "cpu", "--mesh-shape", "1,2", "--batch", "2",
                       "--prompt-len", "4", "--steps", "2", "--cache-len",
                       "8", "--streams", "2"]) == 0
    assert train.main(["--arch", "whisper_tiny", "--reduced", "--device",
                       "cpu", "--mesh-shape", "1,2", "--steps", "2",
                       "--seq-len", "8", "--global-batch", "2",
                       "--log-every", "1"]) == 0
    out = capfd.readouterr().out
    assert out.count("served 2 streams") == 1
    assert "done: 2 steps on 2 rank(s)" in out
