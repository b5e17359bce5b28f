"""Parity of the port's xLSTM (``models/xlstm.py``, ``xlstm_350m``) with the
JAX package on the CPU, and of the configs of every family.

- ``configs/base.py``: every one of the eleven configs and its
  ``reduced()`` equal the reference's field for field; ``ARCH_IDS``,
  ``all_configs``, ``sub_quadratic`` and ``RunConfig.mesh_axis_sizes``
  (flat, nested and asymmetric topologies) too.
- ``mlstm_apply`` in its parallel (D-matrix) and chunkwise (chunk 8)
  forms at S 1, 7, 24 and 64 (64 also with a forget gate pushed to
  log f = -60, where the D matrix underflows: no NaN); ``slstm_apply``
  with and without a carried state.
- Both decode loops (``mlstm_decode``, ``slstm_decode`` one token a step
  from the initial state) against the reference's loops and against the
  port's own full-sequence applies.
- Gradients of both blocks, parameters and input, against ``jax.grad``.
- The reduced ``xlstm_350m`` (one group: 7 mLSTM blocks, then one sLSTM
  block, no FFN; d 256, 4 heads of 128 in d_inner 512): the params tree
  against the port's own ``init_params``, ``loss_fn`` (loss, every metric
  and every gradient; the gradients at 1e-4 of each leaf's largest entry,
  see ``close_scaled``), three trainer steps, the scan prefill of a
  right-padded pack and three decode steps with every recurrent state
  (the states at 1e-4 of their largest entry),
  ``ServingEngine.run`` (greedy tokens exactly the reference's), the
  slot operations on the recurrent-only cache.
- ``launch.serve`` and ``launch.train`` with each of the three families
  of this file and its two neighbours (``--arch xlstm_350m``,
  ``whisper_tiny``, ``internvl2_26b``, ``--reduced --device cpu``).

Blocks run at d 64 (4 heads, d_inner 128); the model at ``reduced()``
size on the reference's ``init_params`` weights (numpy, through
``params_from_numpy``), float32, rtol = atol = 1e-4.  The reference model
is built once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.serving import engine as jengine
from repro_torch.configs import base
from repro_torch.models import decode, model, transformer, xlstm
from repro_torch.optim import adamw
from repro_torch.serving import batching, engine

from torch_family_checks import (TwoRankStub, batches, build,
                                 check_loss_and_grads, check_trainer_steps,
                                 close, close_scaled, prompts, serve_both,
                                 shapes, to_torch)

torch.set_num_threads(2)

ARCH_ID = "xlstm_350m"
D_BLOCK = 64
# the reference's blocks under jit (eager JAX dispatches op by op)
jmlstm = jax.jit(jxlstm.mlstm_apply, static_argnums=2)
jslstm = jax.jit(jxlstm.slstm_apply, static_argnums=2)


def test_every_config_and_the_config_functions_match_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS and len(base.ARCH_IDS) == 11
    mine, theirs = base.all_configs(), jbase.all_configs()
    assert list(mine) == list(theirs) == list(base.ARCH_IDS)
    for aid in base.ARCH_IDS:
        for full in (True, False):
            arch, jarch = mine[aid], theirs[aid]
            if not full:
                arch, jarch = arch.reduced(), jarch.reduced()
            assert [f.name for f in dataclasses.fields(arch)] == [
                f.name for f in dataclasses.fields(jarch)]
            for f in dataclasses.fields(jarch):
                got, want = getattr(arch, f.name), getattr(jarch, f.name)
                if f.name in ("moe", "mla") and want is not None:
                    got, want = dataclasses.asdict(got), dataclasses.asdict(
                        want)
                assert got == want, (aid, full, f.name)
            assert arch.sub_quadratic == jarch.sub_quadratic, aid
            assert arch.head_dim_ == jarch.head_dim_
    assert [a for a in base.ARCH_IDS if not mine[a].sub_quadratic] == [
        "whisper_tiny"]
    assert mine[ARCH_ID].reduced().num_layers == 8
    for topo in ((), 4, (2, 2), ((2, 2), (2, 2)), ((2, 2), (2, 2, 2)),
                 ((3, 3), (3, 3), (3, 3))):
        run, jrun = base.RunConfig(topology=topo), jbase.RunConfig(
            topology=topo)
        assert run.mesh_axis_sizes() == jrun.mesh_axis_sizes(), topo
    with pytest.raises(ValueError, match="unknown arch"):
        base.get_config("gpt5")


def block_params(seed=0):
    """(jax cfg, port cfg, jax mLSTM, port mLSTM, jax sLSTM, port sLSTM)
    float32 blocks at d D_BLOCK."""
    jcfg = jxlstm.XLSTMConfig(d_model=D_BLOCK, num_heads=4,
                              dtype=jnp.float32)
    cfg = xlstm.XLSTMConfig(d_model=D_BLOCK, num_heads=4,
                            dtype=torch.float32)
    jm = jxlstm.init_mlstm(jax.random.PRNGKey(seed), jcfg)
    js = jxlstm.init_slstm(jax.random.PRNGKey(seed + 1), jcfg)
    return jcfg, cfg, jm, to_torch(jm), js, to_torch(js)


def test_mlstm_parallel_and_chunkwise_and_slstm_match_reference():
    """Also: the port's own init gives the reference's tree of shapes and
    dtypes."""
    jcfg, cfg, jm, pm, js, ps = block_params()
    gen = torch.Generator().manual_seed(0)
    assert shapes(xlstm.init_mlstm(cfg, gen, "cpu")) == shapes(pm)
    assert shapes(xlstm.init_slstm(cfg, gen, "cpu")) == shapes(ps)
    for S in (1, 7, 24, 64):
        x = np.random.default_rng(S).standard_normal(
            (2, S, D_BLOCK)).astype(np.float32)
        for ck in (0, 8):
            c, jc = (dataclasses.replace(cfg, chunk_size=ck),
                     dataclasses.replace(jcfg, chunk_size=ck))
            got = xlstm.mlstm_apply(pm, torch.from_numpy(x), c)
            close(got, jmlstm(jm, jnp.asarray(x), jc))
        jy, jst = jslstm(js, jnp.asarray(x), jcfg)
        y, st = xlstm.slstm_apply(ps, torch.from_numpy(x), cfg)
        close(y, jy)
        for k in ("c", "n", "h", "m"):
            close(st[k], jst[k])
        # a carried state: the second half after the first
        if S > 1:
            h = S // 2
            y1, st1 = xlstm.slstm_apply(ps, torch.from_numpy(x[:, :h]), cfg)
            y2, _ = xlstm.slstm_apply(ps, torch.from_numpy(x[:, h:]), cfg,
                                      st1)
            close(torch.cat([y1, y2], 1), jy)
    # forget gates near 0 (log f = -60 a step): the D matrix underflows to
    # zeros below the diagonal and the exp(-m) floor takes over
    strong = dict(pm, b_if=pm["b_if"].clone())
    strong["b_if"][4:] = -60.0
    jstrong = dict(jm, b_if=jm["b_if"].at[4:].set(-60.0))
    x = np.random.default_rng(9).standard_normal(
        (2, 64, D_BLOCK)).astype(np.float32)
    for ck in (0, 8):
        got = xlstm.mlstm_apply(strong, torch.from_numpy(x),
                                dataclasses.replace(cfg, chunk_size=ck))
        assert bool(torch.isfinite(got).all())
        close(got, jmlstm(jstrong, jnp.asarray(x),
                          dataclasses.replace(jcfg, chunk_size=ck)))


def test_decode_loops_match_reference_and_the_full_sequence_applies():
    jcfg, cfg, jm, pm, js, ps = block_params(seed=2)
    S = 12
    x = np.random.default_rng(5).standard_normal(
        (3, S, D_BLOCK)).astype(np.float32)
    xt = torch.from_numpy(x)
    for mixer in ("mlstm", "slstm"):
        p, jp = (pm, jm) if mixer == "mlstm" else (ps, js)
        init = getattr(xlstm, f"init_{mixer}_state")
        jinit = getattr(jxlstm, f"init_{mixer}_state")
        step = getattr(xlstm, f"{mixer}_decode")
        jstep = getattr(jxlstm, f"{mixer}_decode")
        state, jstate = init(3, cfg, "cpu"), jinit(3, jcfg)
        outs = []
        for t in range(S):
            y, state = step(p, xt[:, t:t + 1], state, cfg)
            jy, jstate = jstep(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
            close(y, jy)
            outs.append(y)
        for k in state:
            close(state[k], jstate[k])
        if mixer == "mlstm":
            full = xlstm.mlstm_apply(p, xt, cfg)
        else:
            full, _ = xlstm.slstm_apply(p, xt, cfg)
        close(torch.cat(outs, 1), full.detach())


def test_block_gradients_match_jax_grad():
    """d(sum(out * w)) by the parameters and the input: mLSTM parallel and
    chunkwise, and sLSTM, at S 16."""
    jcfg, cfg, jm, pm, js, ps = block_params(seed=4)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, D_BLOCK)).astype(np.float32)
    w = rng.standard_normal((2, 16, D_BLOCK)).astype(np.float32)
    cases = [("mlstm", 0), ("mlstm", 8), ("slstm", 0)]
    for mixer, ck in cases:
        c, jc = (dataclasses.replace(cfg, chunk_size=ck),
                 dataclasses.replace(jcfg, chunk_size=ck))
        jp = jm if mixer == "mlstm" else js

        def jloss(p, xx):
            if mixer == "mlstm":
                out = jxlstm.mlstm_apply(p, xx, jc)
            else:
                out, _ = jxlstm.slstm_apply(p, xx, jc)
            return jnp.sum(out * jnp.asarray(w))

        jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jp, jnp.asarray(x))
        p = to_torch(jp)
        leaves = adamw.tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        if mixer == "mlstm":
            out = xlstm.mlstm_apply(p, xt, c)
        else:
            out, _ = xlstm.slstm_apply(p, xt, c)
        (out * torch.from_numpy(w)).sum().backward()
        close(xt.grad, jg_x)
        want = adamw.tree_leaves(to_torch(jg_p))
        assert len(want) == len(leaves)
        for a, b in zip(leaves, want):
            close(a.grad, b)


@pytest.fixture(scope="module")
def built(mesh11):
    return build(mesh11, ARCH_ID)


def test_model_params_loss_metrics_and_grads_match_reference(mesh11, built):
    jctx, _, ctx, params = built
    own = model.init_params(ctx, torch.Generator().manual_seed(0), "cpu")
    assert shapes(params) == shapes(own)
    subs = transformer.layer_list(ctx.arch)
    assert [(s.mixer, s.ffn) for s in subs] == [("mlstm", None)] * 7 + [
        ("slstm", None)]
    jgroup = jtransformer.layer_plan(jctx.arch)[1]
    assert [(s.mixer, s.ffn) for s in jgroup] == [(s.mixer, s.ffn)
                                                  for s in subs]
    for p in params["layers"]:
        assert set(p) == {"norm1", "mixer"}
    check_loss_and_grads(mesh11, built, batches(ctx.arch, jctx.arch),
                         grads_close=close_scaled)


def test_trainer_steps_match_reference(mesh11, built):
    """The first step free-running, each later one from the reference's
    state (``check_trainer_steps``): free-running, the reduced xLSTM's
    grad norm parts from the reference's by 0.5% at the second step and
    15% at the third, as AdamW's first normalized update turns f32
    rounding in near-zero gradients into moves of up to lr.  From the
    reference's state the third step's grad norm (75.07) lies 2.0e-4
    (relative) from the reference's: the gradients' amplified rounding of
    ``close_scaled``, summed; it is held at 1e-3."""
    check_trainer_steps(mesh11, built, from_reference_state=True,
                        grad_norm_rtol=1e-3)


def check_states(cache, jcache):
    for i, layer in enumerate(cache):
        jlayer = jax.tree_util.tree_map(
            lambda a: a[0], jcache["groups"][f"sub{i}"]["mixer"])
        names = {"c", "n", "h", "m"} if i == 7 else {"C", "n", "m"}
        assert set(layer) == {"mixer"}
        assert set(layer["mixer"]) == set(jlayer) == names
        for k, v in jlayer.items():
            # at 1e-4 of the tensor's largest entry (``close_scaled``): the
            # sLSTM's state after 11 + 3 steps fed by seven mLSTM blocks
            # lies up to 1.7e-4 from the reference's, at entries of 0.5
            close_scaled(layer["mixer"][k], v)


SERVE_LENS, SERVE_BUDGETS = [3, 14, 7, 1, 16, 9], [4, 2, 6, 3, 5, 1]
SERVE_CFG = dict(num_slots=4, cache_len=24, prefill_pack=2,
                 prompt_buckets=(16,))


def test_scan_prefill_decode_serving_and_slot_ops_match_reference(built):
    """A right-padded pack of 3 prompts in 4 rows: the scan prefill
    freezes each row's mLSTM and sLSTM states past its length; three
    greedy decode steps; then ``ServingEngine.run`` and the slot
    operations on the recurrent-only cache (no ``pos`` anywhere)."""
    jctx, jparams, ctx, params = built
    ps = prompts(ctx.arch.vocab_size, [5, 11, 2], seed=0)
    tok, lens = batching.pad_pack(ps, pack=4, buckets=(16,), device="cpu")
    jlg, jcache = jax.jit(jengine.make_prefill(
        jctx, with_cache=True, cache_len=24))(
        jparams, {"tokens": jnp.asarray(tok.numpy()),
                  "lens": jnp.asarray(lens.numpy())})
    lg, cache = engine.make_prefill(ctx, with_cache=True, cache_len=24)(
        params, {"tokens": tok, "lens": lens})
    close(lg, jlg)
    check_states(cache, jcache)
    jstep = jax.jit(jengine.make_decode_step(jctx))
    step = engine.make_decode_step(ctx)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(
            np.asarray(torch.argmax(lg, dim=-1))[:, None], nxt)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(nxt))
        lg, cache = step(params, cache, torch.from_numpy(nxt))
        jlg, lg = jlg[:, 0], lg[:, 0]
        close(lg, jlg)
    check_states(cache, jcache)

    want, got = serve_both(built, SERVE_CFG, SERVE_LENS, SERVE_BUDGETS)
    for i in range(len(SERVE_LENS)):
        assert got.tokens_for(i) == want[i], i

    kv = batching.SlotKVCache(ctx, num_slots=3, cache_len=8)
    src = decode.init_cache(ctx, 2, 6, device="cpu")
    for i, layer in enumerate(src):
        for leaf in layer["mixer"].values():
            leaf.fill_(1.0 + i)
    kv.insert(src, np.asarray([2, 3]))            # id 3 == num_slots: dropped
    hd = ctx.xlstm_cfg.head_dim
    fresh = decode.init_cache(ctx, 3, 8, device="cpu")
    for i, (layer, new) in enumerate(zip(kv.cache, fresh)):
        c = layer["mixer"]
        if i == 7:
            assert tuple(c["h"].shape) == (3, 4, 64)
        else:
            assert tuple(c["C"].shape) == (3, 4, hd, hd)
        for name, leaf in c.items():
            assert float(leaf[2].min()) == float(leaf[2].max()) == 1.0 + i
            # the other slots keep their initial state (m at -1e30)
            assert torch.equal(leaf[:2], new["mixer"][name][:2])
    gathered = decode.gather_cache_rows(TwoRankStub(), src, 4)
    for layer, g in zip(src, gathered):
        for name, leaf in layer["mixer"].items():     # nothing to cut
            assert torch.equal(g["mixer"][name], torch.cat([leaf, leaf]))
    kv.evict([2])
    for layer in kv.cache:
        for leaf in layer["mixer"].values():
            assert float(leaf[2].abs().max()) == 0.0
    with pytest.raises(ValueError, match="no pos leaf"):
        kv.positions()


def test_launchers_run_the_three_families_on_cpu(capsys):
    from repro_torch.launch import serve, train
    for aid in ("xlstm_350m", "whisper_tiny", "internvl2_26b"):
        assert serve.main(["--arch", aid, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "4", "--steps",
                           "3", "--cache-len", "16", "--streams", "3"]) == 0
        assert "served 3 streams" in capsys.readouterr().out
        assert serve.main(["--arch", aid, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "4", "--steps",
                           "3", "--cache-len", "16"]) == 0
        assert "generated (2, 3) tokens" in capsys.readouterr().out
        assert train.main(["--arch", aid, "--reduced", "--device", "cpu",
                           "--steps", "2", "--seq-len", "24",
                           "--global-batch", "2", "--log-every", "1"]) == 0
        assert "done: 2 steps on 1 rank(s)" in capsys.readouterr().out
