"""Parity of the port's Whisper encoder-decoder (``whisper_tiny``: the
encoder over the frame stub of ``models/whisper.py``, the decoder's
cross-attention, its cross K/V cache) with the JAX package on the CPU.

- ``SyntheticLM`` batches with their frames bit-equal to the reference's;
  ``make_frames`` from one seed equal; ``layer_plan`` (attention with
  cross-attention, an FFN) and ``encoder_plan`` (non-causal); the params
  tree (``enc_layers``, ``enc_norm``, each decoder layer's ``norm_cross``
  and ``cross``) against the port's own ``init_params``.
- ``_run_encoder``, ``_cross_attn`` and ``decode.fill_cross_cache``.
- ``loss_fn``: the loss, every metric and every gradient; three trainer
  steps.
- ``decode.prefill`` with frames (the encoder fills the cross K/V, then a
  scan of decode steps, as the reference prefills cross-attention
  decoders) and three decode steps: the logits, the greedy tokens, the
  self-attention K/V (below ``pos`` after the prefill: see
  ``test_torch_jamba.py``) and the cross K/V.
- ``ServingEngine.run`` with ``use_flash=True`` (the encoder's
  non-causal attention through K5's entry, its plain version on the CPU)
  and per-request frames: exactly the reference engine's greedy tokens.
- The cross K/V through ``cache_insert_slots``, ``cache_evict_slots`` and
  ``gather_cache_rows`` (a two-rank stub): no position axis to cut or pad.
- K5's entry (the plain version CPU tensors take) non-causal at a ragged
  length (100 = 3 blocks of 32 and 4 rows), Whisper's 6 heads of 64,
  against the reference's Pallas kernel in interpret mode.

float32 at ``reduced()`` size (2 encoder and 2 decoder layers, d 256, 4
heads of 64, 16 frames, vocab 512, layernorm, gelu) on the reference's
``init_params`` weights; rtol = atol = 1e-4.  The reference model is
built once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.models import decode as jdecode
from repro.models import transformer as jtransformer
from repro.models import whisper as jwhisper
from repro.serving import engine as jengine
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models import decode, model, transformer, whisper
from repro_torch.serving import batching, engine

from torch_family_checks import (TwoRankStub, batches, build,
                                 check_loss_and_grads, check_trainer_steps,
                                 close, prompts, serve_both, shapes)

torch.set_num_threads(2)

ARCH_ID = "whisper_tiny"


@pytest.fixture(scope="module")
def built(mesh11):
    return build(mesh11, ARCH_ID)


def test_frames_plans_and_params_match_reference(built):
    jctx, _, ctx, params = built
    arch = ctx.arch
    assert (arch.frontend, arch.frontend_len, arch.enc_layers,
            arch.num_layers) == ("audio", 16, 2, 2)
    for step in (0, 3):
        b = batches(arch, jctx.arch, step)
        assert b["frontend"].shape == (4, 16, 256)
        assert b["loss_mask"].min() == 1.0
    for n in (1, 3):
        got = whisper.make_frames(np.random.default_rng(n), n, arch)
        want = jwhisper.make_frames(np.random.default_rng(n), n, jctx.arch)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert whisper.frame_shape(2, dataclasses.replace(
        arch, frontend_len=0)) == (2, whisper.FRAMES_PER_CLIP, 256)
    jgroup, group = (jtransformer.layer_plan(jctx.arch)[1],
                     transformer.layer_plan(arch)[1])
    assert [dataclasses.astuple(s) for s in group] == [
        dataclasses.astuple(s) for s in jgroup] == [("attn", "mlp", True,
                                                     True)]
    (enc,), n_enc = transformer.encoder_plan(arch)
    (jenc,), jn = jtransformer.encoder_plan(jctx.arch)
    assert dataclasses.astuple(enc) == dataclasses.astuple(jenc) == (
        "attn", "mlp", False, False) and n_enc == jn == 2
    own = model.init_params(ctx, torch.Generator().manual_seed(0), "cpu")
    assert shapes(params) == shapes(own)
    assert list(params) == list(own) == ["embed", "final_norm", "layers",
                                         "enc_layers", "enc_norm"]
    assert len(params["enc_layers"]) == 2
    for p in params["layers"]:
        assert set(p) == {"norm1", "mixer", "norm_cross", "cross", "norm2",
                          "ffn"}
    for p in params["enc_layers"]:
        assert set(p) == {"norm1", "mixer", "norm2", "ffn"}


def test_encoder_cross_attn_and_cross_cache_match_reference(built):
    jctx, jparams, ctx, params = built
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((3, 16, 256)).astype(np.float32)
    want = jax.jit(lambda p, f: jtransformer._run_encoder(p, f, jctx))(
        jparams, jnp.asarray(frames))
    for c in (ctx, dataclasses.replace(ctx, use_flash=True)):
        with torch.no_grad():
            enc = transformer._run_encoder(params, torch.from_numpy(frames),
                                           c)
        close(enc, want)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    p0 = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["groups"]["sub0"]["cross"])
    with torch.no_grad():
        got = transformer._cross_attn(params["layers"][0]["cross"],
                                      torch.from_numpy(x), enc, ctx)
    close(got, jtransformer._cross_attn(p0, jnp.asarray(x), want, jctx))
    jcache = jdecode.fill_cross_cache(
        jparams, jdecode.init_cache(jctx, 3, 8), want, jctx)
    cache = decode.init_cache(ctx, 3, 8, device="cpu")
    for layer in cache:
        assert float(layer["cross"]["k"].abs().max()) == 0.0
        assert tuple(layer["cross"]["k"].shape) == (3, 16, 4, 64)
    with torch.no_grad():
        cache = decode.fill_cross_cache(params, cache, enc, ctx)
    for i, layer in enumerate(cache):
        for name in ("k", "v"):
            close(layer["cross"][name],
                  jcache["groups"]["sub0"][f"cross_{name}"][i])


def test_loss_metrics_and_grads_match_reference(mesh11, built):
    jctx, _, ctx, _ = built
    check_loss_and_grads(mesh11, built, batches(ctx.arch, jctx.arch))


def test_trainer_steps_match_reference(mesh11, built):
    check_trainer_steps(mesh11, built)


def check_cache(cache, jcache, below_pos=False):
    """Self-attention K/V (with ``below_pos``, at positions ``< pos``
    only) and the cross K/V of every decoder layer."""
    for i, layer in enumerate(cache):
        jg = jax.tree_util.tree_map(lambda a, g=i: a[g],
                                    jcache["groups"]["sub0"])
        assert set(layer) == {"mixer", "cross"}
        for name in ("k", "v"):
            close(layer["cross"][name], jg[f"cross_{name}"])
        for k, v in jg["mixer"].items():
            got, want = layer["mixer"][k].numpy(), np.asarray(v)
            if below_pos and k in ("k", "v"):
                seen = (np.arange(got.shape[1])[None, :]
                        < np.asarray(jg["mixer"]["pos"])[:, None])
                got, want = got[seen], want[seen]
            close(got, want)


def test_prefill_and_decode_match_reference(built):
    """A right-padded pack of 3 prompts with their frames in 4 rows (the
    fourth padded: zero frames, a one-token prompt), then three greedy
    decode steps."""
    jctx, jparams, ctx, params = built
    ps = prompts(ctx.arch.vocab_size, [5, 11, 2], seed=0)
    tok, lens = batching.pad_pack(ps, pack=4, buckets=(16,), device="cpu")
    frames = whisper.make_frames(np.random.default_rng(2), 3, ctx.arch)
    fr = batching.pad_frontend_pack(list(frames), 4, "cpu")
    assert float(fr[3].abs().max()) == 0.0
    jlg, jcache = jax.jit(jengine.make_prefill(
        jctx, with_cache=True, cache_len=24))(
        jparams, {"tokens": jnp.asarray(tok.numpy()),
                  "lens": jnp.asarray(lens.numpy()),
                  "frontend": jnp.asarray(fr.numpy())})
    lg, cache = engine.make_prefill(ctx, with_cache=True, cache_len=24)(
        params, {"tokens": tok, "lens": lens, "frontend": fr})
    close(lg, jlg)
    np.testing.assert_array_equal(cache[0]["mixer"]["pos"].numpy(),
                                  lens.numpy())
    check_cache(cache, jcache, below_pos=True)
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
    check_cache(cache, jcache)


SERVE_LENS, SERVE_BUDGETS = [3, 14, 7, 1, 16, 9], [4, 2, 6, 3, 5, 1]
SERVE_CFG = dict(num_slots=4, cache_len=24, prefill_pack=2,
                 prompt_buckets=(16,))


def test_serving_engine_with_frames_matches_reference(built):
    """Each request carries its own frames (one carries none: its pack
    row gets zero frames, as in the reference)."""
    _, _, ctx, _ = built
    frames = [f.numpy() for f in whisper.make_frames(
        np.random.default_rng(4), len(SERVE_LENS), ctx.arch)]
    frames[3] = None
    want, got = serve_both(built, SERVE_CFG, SERVE_LENS, SERVE_BUDGETS,
                           frontends=frames,
                           ctx=dataclasses.replace(ctx, use_flash=True))
    for i in range(len(SERVE_LENS)):
        assert got.tokens_for(i) == want[i], i


def test_cross_cache_through_the_slot_ops(built):
    """The cross K/V (16 frames) beside the decoder's K/V (cache_len
    positions): an insert from a pack cache 6 positions long pads only the
    decoder's K/V; ``gather_cache_rows`` cuts only the decoder's K/V."""
    _, _, ctx, _ = built
    kv = batching.SlotKVCache(ctx, num_slots=3, cache_len=8)
    src = decode.init_cache(ctx, 2, 6, device="cpu")
    for i, layer in enumerate(src):
        for part in layer.values():
            for leaf in part.values():
                leaf.fill_(1.0 + i)
        layer["mixer"]["pos"].fill_(5)
    kv.insert(src, np.asarray([0, 3]))            # id 3 == num_slots: dropped
    np.testing.assert_array_equal(kv.positions(), [5, 0, 0])
    for i, layer in enumerate(kv.cache):
        assert tuple(layer["cross"]["k"].shape) == (3, 16, 4, 64)
        assert tuple(layer["mixer"]["k"].shape) == (3, 8, 4, 64)
        for name in ("k", "v"):
            assert float(layer["cross"][name][0].min()) == 1.0 + i
            assert float(layer["cross"][name][0].max()) == 1.0 + i
            assert float(layer["mixer"][name][0, :6].min()) == 1.0 + i
            assert float(layer["mixer"][name][0, 6:].abs().max()) == 0.0
            for part in ("cross", "mixer"):
                assert float(layer[part][name][1:].abs().max()) == 0.0
    gathered = decode.gather_cache_rows(TwoRankStub(), src, 4)
    for layer, g in zip(src, gathered):
        assert set(g) == {"mixer", "cross"}
        for name, leaf in layer["cross"].items():
            assert torch.equal(g["cross"][name], torch.cat([leaf, leaf]))
        for name, leaf in layer["mixer"].items():
            cut = leaf[:, :4] if leaf.dim() > 1 else leaf
            assert torch.equal(g["mixer"][name], torch.cat([cut, cut]))
    kv.evict([0])
    np.testing.assert_array_equal(kv.positions(), [0, 0, 0])
    for layer in kv.cache:
        for part in layer.values():
            for leaf in part.values():
                assert float(leaf.abs().max()) == 0.0


def test_flash_entry_noncausal_at_a_ragged_length_matches_pallas():
    """The encoder's K5 call: non-causal, Sq = Sk = 100 (blocks of 32: the
    last query and key blocks hold 4 rows), 6 heads of 64."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 100, 6, 64)).astype(np.float32)
               for _ in range(3))
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=False)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, block_q=32,
                                  block_k=32, interpret=True)
    close(got, want)
