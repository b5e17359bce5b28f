"""Parity of the port's Jamba hybrid (``jamba_v0_1_52b``) with the JAX
package on the CPU.

- The config and ``reduced()`` equal the reference's field for field, and
  ``layer_plan`` gives the same (mixer, ffn) list: attention at 4 of each
  group of 8, Mamba elsewhere, an MoE FFN at every second layer
  (``moe_period`` 2).
- ``params_from_numpy`` carries the reference's parameters across (the
  Mamba leaves, the alternating dense and MoE FFNs), and the port's own
  ``init_params`` makes the same tree; at bf16 ``A_log``, ``D`` and
  ``b_dt`` stay float32.
- ``loss_fn`` with ``aux_mode="ta"`` and ``dispatch="a2a"``: the loss,
  every metric and every gradient; three trainer steps.
- ``decode.prefill`` of a right-padded pack (a scan of decode steps, as
  the reference prefills recurrent models) and three decode steps: the
  logits, the greedy tokens (exact), the Mamba states and the KV caches.
  After the prefill the KV caches are compared at positions ``< pos``:
  the port leaves the row a frozen request's scan step wrote at its
  ``pos`` (never attended; its first decode step overwrites it), where
  the reference reverts it to zero.  After the decode steps the whole
  caches are compared.
- The slot operations and ``SlotKVCache.positions`` on the hybrid cache,
  whose layer 0 is a Mamba layer without ``pos``.
- ``ServingEngine.run``: exactly the reference engine's greedy tokens.
- ``launch.serve`` and ``launch.train`` with ``--arch jamba_v0_1_52b
  --reduced --device cpu``.

Both packages compute with the reference's ``init_params`` weights (as
numpy, through ``params_from_numpy``) on ``SyntheticLM`` batches; float32
at ``reduced()`` size (one group of 8 layers: 7 Mamba, 1 attention, 4 MoE
layers of 4 experts top-2; d 256, d_inner 512); rtol = atol = 1e-4.  The
reference model is built once, in a module fixture.

Run as a script (``PYTHONPATH=src python tests/test_torch_jamba.py``) it
prints how far each package's bf16 forward lies from its float32 forward
(relative Frobenius distance of the logits) on the same weights: reduced
Jamba at 16 layers and d 512, two prompts of 32 tokens.  Random-weight
Jamba drifts far in bf16 in both, which bounds what the card's float32
verdict can ask of the kernel path.
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
from repro_torch.models import decode, model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.serving import batching, engine
from repro_torch.serving.scheduler import Request
from repro_torch.training import trainer

torch.set_num_threads(2)

ARCH_ID = "jamba_v0_1_52b"
TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 32, 4


def close(got, want):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def init_reference(mesh, jarch, **kw):
    jctx = jmodel.build_ctx(jarch, mesh, seq_len=SEQ, global_batch=BATCH,
                            **kw)
    with mesh, sharding.axis_rules(jmodel.default_rules(mesh)):
        jparams = jax.jit(lambda key: jmodel.init_params(key, jctx))(
            jax.random.PRNGKey(0))
    return jctx, jparams


@pytest.fixture(scope="module")
def built(mesh11):
    """(jax ctx, jax params, port ctx, port params) of reduced Jamba, the
    weights the reference's ``init_params`` from key 0."""
    jctx, jparams = init_reference(mesh11, jax_get_config(ARCH_ID).reduced(),
                                   aux_mode="ta")
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), seq_len=SEQ,
                          global_batch=BATCH, aux_mode="ta", device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               ctx, "cpu")
    return jctx, jparams, ctx, params


def shapes(tree, path=()):
    if isinstance(tree, dict):
        return sum((shapes(tree[k], path + (k,)) for k in sorted(tree)), [])
    if isinstance(tree, list):
        return sum((shapes(v, path + (i,)) for i, v in enumerate(tree)), [])
    return [(path, tuple(tree.shape), tree.dtype)]


def test_config_reduced_and_layer_plan_match_reference():
    for full in (False, True):
        jarch, arch = jax_get_config(ARCH_ID), get_config(ARCH_ID)
        if not full:
            jarch, arch = jarch.reduced(), arch.reduced()
        for f in dataclasses.fields(arch):
            want = getattr(jarch, f.name)
            if f.name == "moe":
                want = dataclasses.asdict(want)
                assert dataclasses.asdict(arch.moe) == want
            else:
                assert getattr(arch, f.name) == want, f.name
        for f in dataclasses.fields(jarch):       # fields the port lacks
            if not hasattr(arch, f.name):
                assert getattr(jarch, f.name) == f.default, f.name
        jprefix, jgroup, jn = jtransformer.layer_plan(jarch)
        prefix, group, n = transformer.layer_plan(arch)
        assert (len(prefix), n) == (len(jprefix), jn) == (0, arch.num_layers
                                                          // 8)
        assert [(s.mixer, s.ffn) for s in group] == [
            (s.mixer, s.ffn) for s in jgroup] == [
            ("attn" if j == 4 else "mamba", "moe" if j % 2 else "mlp")
            for j in range(8)]
    assert arch.reduced().num_layers == 8
    # the ssm family with xlstm takes the xLSTM plan, not the hybrid's
    xl = dataclasses.replace(arch, family="ssm", ssm_kind="xlstm")
    assert [(s.mixer, s.ffn) for s in transformer.layer_plan(xl)[1]] == [
        ("mlstm", None)] * 7 + [("slstm", None)]


def test_converted_params_match_the_ports_own_init(mesh11, built):
    """float32 at ``reduced()``, and the same arch in bf16: the reference's
    tree converted against the port's ``init_params``, leaf for leaf in
    shape and (outside the MoE FFNs, see below) dtype."""
    _, _, ctx, params = built
    own = model.init_params(ctx, torch.Generator().manual_seed(0), "cpu")
    assert shapes(params) == shapes(own)
    subs = transformer.layer_list(ctx.arch)
    for p, sub in zip(params["layers"], subs):
        want = ({"w_in", "conv_w", "conv_b", "w_x_dbc", "w_dt", "b_dt",
                 "A_log", "D", "w_out"} if sub.mixer == "mamba"
                else {"wq", "wk", "wv", "wo"})
        assert set(p["mixer"]) == want
        assert ("gate" in p["ffn"]) == (sub.ffn == "moe")
    bf16 = dataclasses.replace(get_config(ARCH_ID).reduced(),
                               dtype="bfloat16")
    jctx16 = jmodel.build_ctx(
        dataclasses.replace(jax_get_config(ARCH_ID).reduced(),
                            dtype="bfloat16"), mesh11, seq_len=SEQ,
        global_batch=BATCH)
    with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
        tree = jax.eval_shape(lambda key: jmodel.init_params(key, jctx16),
                              jax.random.PRNGKey(0))
    ctx16 = model.build_ctx(bf16, seq_len=SEQ, global_batch=BATCH,
                            device="cpu")
    conv = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), tree), ctx16, "cpu")
    own = model.init_params(ctx16, torch.Generator().manual_seed(0), "cpu")
    # the reference's MoE init multiplies by a numpy float64 scale, which
    # promotes its bf16 expert weights to float32; the port keeps bf16:
    # dtypes are compared outside the MoE FFNs
    assert [(k, sh) for k, sh, _ in shapes(conv)] == [
        (k, sh) for k, sh, _ in shapes(own)]
    assert [x for x in shapes(conv) if "ffn" not in x[0]] == [
        x for x in shapes(own) if "ffn" not in x[0]]
    mixer = own["layers"][0]["mixer"]
    assert {k for k, v in mixer.items() if v.dtype == torch.float32} == {
        "A_log", "D", "b_dt"}
    assert mixer["w_in"].dtype == torch.bfloat16


def _batch(arch):
    b = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0)).batch(0)
    return {k: np.asarray(v) for k, v in b.items()}


def test_loss_metrics_and_grads_match_reference(mesh11, built):
    jctx, jparams, ctx, params = built
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
    assert set(m) == set(jm) == {"nll", "aux", "loss", "frac_by_level",
                                 "dropped"}
    for k in m:
        close(m[k], jm[k])
    want = adamw.tree_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), ctx, "cpu"))
    assert len(want) == len(grads)
    for a, b in zip(grads, want):
        close(a, b)


def test_trainer_steps_match_reference(mesh11, built):
    """Three steps from copies of the fixture's weights (the port's AdamW
    updates in place): lr 3e-4 after a one-step warmup, TA at weight 1."""
    from repro.optim import adamw as jadamw
    jctx, jparams, ctx, _ = built
    run_kw = dict(seq_len=SEQ, global_batch=BATCH, warmup_steps=1, seed=0,
                  aux_mode="ta")
    jrun = JRunConfig(**run_kw)
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=jctx.arch.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0), jctx.arch)
    want = []
    with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
        jstep = jax.jit(jtrainer.make_train_step(jctx, jrun))
        # placed as the step's outputs are, so every step hits one compile
        jp, jo = jax.device_put((jparams, jadamw.init_state(jparams)),
                                NamedSharding(mesh11, PartitionSpec()))
        for i in range(3):
            jp, jo, m = jstep(jp, jo, data.batch(i))
            want.append(m)
    got = trainer.train(ctx.arch, RunConfig(**run_kw), None, steps=3,
                        log_every=1, verbose=False,
                        params=params_from_numpy(
                            jax.tree_util.tree_map(np.array, jparams), ctx,
                            "cpu"),
                        device="cpu").metrics_history
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("loss", "nll", "aux", "dropped", "grad_norm"):
            close(g[k], w[k])


def prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def check_cache(cache, jcache, below_pos=False):
    """The port's per-layer cache against the reference's stacked group
    cache: every leaf of every layer, whole, or with ``below_pos`` the
    K/V rows at positions ``< pos`` only."""
    for i, layer in enumerate(cache):
        jlayer = jax.tree_util.tree_map(
            lambda a, g=i // 8: a[g], jcache["groups"][f"sub{i % 8}"]["mixer"])
        names = {"k", "v", "pos"} if i == 4 else {"h", "conv"}
        assert set(layer["mixer"]) == set(jlayer) == names
        for k, v in jlayer.items():
            got, want = layer["mixer"][k].numpy(), np.asarray(v)
            if below_pos and k in ("k", "v"):
                pos = np.asarray(jlayer["pos"])
                seen = np.arange(got.shape[1])[None, :] < pos[:, None]
                got, want = got[seen], want[seen]
            close(got, want)


def test_scan_prefill_and_decode_match_reference(built):
    """A right-padded pack of 3 prompts in 4 rows (the fourth a padded
    row of length 1): the scan prefill freezes each row's Mamba state and
    KV cache past its length; then three greedy decode steps."""
    jctx, jparams, ctx, params = built
    ps = prompts(ctx.arch.vocab_size, [5, 11, 2], seed=0)
    cache_len = 24
    tok, lens = batching.pad_pack(ps, pack=4, buckets=(16,), device="cpu")
    jlg, jcache = jax.jit(jengine.make_prefill(
        jctx, with_cache=True, cache_len=cache_len))(
        jparams, {"tokens": jnp.asarray(tok.numpy()),
                  "lens": jnp.asarray(lens.numpy())})
    jstep = jax.jit(jengine.make_decode_step(jctx))
    lg, cache = engine.make_prefill(ctx, with_cache=True,
                                    cache_len=cache_len)(
        params, {"tokens": tok, "lens": lens})
    close(lg, jlg)
    np.testing.assert_array_equal(cache[4]["mixer"]["pos"].numpy(),
                                  lens.numpy())
    check_cache(cache, jcache, below_pos=True)
    step = engine.make_decode_step(ctx)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(
            np.asarray(torch.argmax(lg, dim=-1))[:, None], nxt)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(nxt))
        lg, cache = step(params, cache, torch.from_numpy(nxt))
        jlg, lg = jlg[:, 0], lg[:, 0]
        close(lg, jlg)
    check_cache(cache, jcache)


class _TwoRankStub:
    """A stand-in world of two ranks whose all-gather stacks two copies
    of a rank's rows: enough for ``gather_cache_rows``' cuts."""
    size = 2
    axis_names = ("data",)

    def all_gather(self, t, axes):
        return torch.cat([t, t])


def test_slot_ops_hold_for_the_hybrid_cache(built):
    """Layer 0 is a Mamba layer (no ``pos``): insert, evict, positions and
    gather_cache_rows take the slot count from a leaf's axis 0, ``pos``
    from the attention layer, and cut only the position axis of the
    attention layer's leaves."""
    _, _, ctx, _ = built
    kv = batching.SlotKVCache(ctx, num_slots=3, cache_len=8)
    src = decode.init_cache(ctx, 2, 6, device="cpu")
    for i, layer in enumerate(src):
        for leaf in layer["mixer"].values():
            leaf.fill_(1.0 + i)
        if "pos" in layer["mixer"]:
            layer["mixer"]["pos"].fill_(5)
    kv.insert(src, np.asarray([2, 3]))            # id 3 == num_slots: dropped
    np.testing.assert_array_equal(kv.positions(), [0, 0, 5])
    di = 2 * ctx.arch.d_model
    for i, layer in enumerate(kv.cache):
        c = layer["mixer"]
        if i == 4:
            assert tuple(c["k"].shape) == (3, 8, 4, 64)
            assert float(c["k"][2, :6].min()) == 1.0 + i
            assert float(c["v"][2, 6:].abs().max()) == 0.0   # past the source
        else:
            assert tuple(c["h"].shape) == (3, di, 16)
            assert tuple(c["conv"].shape) == (3, 3, di)
            for leaf in c.values():
                assert float(leaf[2].min()) == float(leaf[2].max()) == 1.0 + i
        for leaf in c.values():
            assert float(leaf[:2].abs().max()) == 0.0
    gathered = decode.gather_cache_rows(_TwoRankStub(), src, 4)
    for layer, g in zip(src, gathered):
        for name, leaf in layer["mixer"].items():
            cut = leaf[:, :4] if ("pos" in layer["mixer"]
                                  and leaf.dim() > 1) else leaf
            assert torch.equal(g["mixer"][name], torch.cat([cut, cut]))
    kv.evict([2])
    np.testing.assert_array_equal(kv.positions(), [0, 0, 0])
    for layer in kv.cache:
        for leaf in layer["mixer"].values():
            assert float(leaf.abs().max()) == 0.0
    kv.cache = [layer for layer in kv.cache if "pos" not in layer["mixer"]]
    with pytest.raises(ValueError, match="no pos leaf"):
        kv.positions()


SERVE_LENS, SERVE_BUDGETS = [3, 14, 7, 1, 16, 9], [4, 2, 6, 3, 5, 1]
SERVE_CFG = dict(num_slots=4, cache_len=24, prefill_pack=2,
                 prompt_buckets=(16,))


def test_serving_engine_greedy_tokens_match_reference(built):
    """Through the unfused gather branch (auto on the CPU) and the fused
    one (``use_pallas=True``: K4's entry, its plain version on the CPU),
    with ``use_flash=True``, which the scan prefill never reaches."""
    jctx, jparams, ctx0, params = built
    ps = prompts(ctx0.arch.vocab_size, SERVE_LENS, seed=3)
    rep = jengine.ServingEngine(jparams, jctx,
                                jengine.ServeConfig(**SERVE_CFG)).run(
        [JRequest(uid=i, tokens=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(ps, SERVE_BUDGETS))])
    want = [[int(v) for v in rep.tokens_for(i)] for i in range(len(ps))]
    for use_pallas in (None, True):
        ctx = dataclasses.replace(ctx0, use_pallas=use_pallas,
                                  use_flash=True)
        got = engine.ServingEngine(params, ctx,
                                   engine.ServeConfig(**SERVE_CFG)).run(
            [Request(uid=i, tokens=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(ps, SERVE_BUDGETS))])
        assert got.total_new_tokens == sum(SERVE_BUDGETS)
        for i in range(len(ps)):
            assert got.tokens_for(i) == want[i], (use_pallas, i)


def test_launchers_run_jamba_on_cpu(capsys):
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", ARCH_ID, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--steps", "3",
                       "--cache-len", "16", "--streams", "3"]) == 0
    assert "served 3 streams" in capsys.readouterr().out
    assert train.main(["--arch", ARCH_ID, "--reduced", "--device", "cpu",
                       "--steps", "2", "--seq-len", "16", "--global-batch",
                       "2", "--log-every", "1"]) == 0
    assert "done: 2 steps on 1 rank(s)" in capsys.readouterr().out


def _bf16_drift():
    """The script mode of the module docstring."""
    from repro.compat import make_mesh

    def arch_of(get, dtype):
        return dataclasses.replace(get(ARCH_ID).reduced(), num_layers=16,
                                   d_model=512, dtype=dtype)

    mesh = make_mesh((1, 1), ("data", "model"))
    jctx32 = jmodel.build_ctx(arch_of(jax_get_config, "float32"), mesh,
                              seq_len=SEQ, global_batch=2)
    with mesh, sharding.axis_rules(jmodel.default_rules(mesh)):
        jp32 = jax.jit(lambda key: jmodel.init_params(key, jctx32))(
            jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(0, 512, size=(2, SEQ)).astype(
        np.int32)
    keep_f32 = ("A_log", "D", "b_dt", "scale", "w")   # f32 in both inits
    logits = {}
    for dt in ("float32", "bfloat16"):
        jctx = jmodel.build_ctx(arch_of(jax_get_config, dt), mesh,
                                seq_len=SEQ, global_batch=2)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: a if dt == "float32" or any(
                getattr(k, "key", None) in keep_f32 for k in path)
            else a.astype(jnp.bfloat16), jp32)
        with mesh, sharding.axis_rules(jmodel.default_rules(mesh)):
            lg, _ = jax.jit(lambda p: jtransformer.forward(
                p, {"tokens": jnp.asarray(tok)}, jctx))(jp)
        logits["reference", dt] = np.asarray(lg, np.float32)
        ctx = model.build_ctx(arch_of(get_config, dt), seq_len=SEQ,
                              global_batch=2, device="cpu")
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   ctx, "cpu")
        with torch.no_grad():
            lg, _ = transformer.forward(params,
                                        {"tokens": torch.from_numpy(tok)},
                                        ctx)
        logits["port", dt] = lg.numpy()
    for pkg in ("reference", "port"):
        a, b = logits[pkg, "bfloat16"], logits[pkg, "float32"]
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        print(f"{pkg}: bf16 logits {rel:.4f} (relative) from float32")


if __name__ == "__main__":
    _bf16_drift()
