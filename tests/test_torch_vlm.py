"""Parity of the port's InternVL2 (``internvl2_26b``: the patch stub of
``models/vlm.py``, the 2-layer projector ``proj`` and the splice of the
projected patches over the first ``frontend_len`` positions) with the JAX
package on the CPU.

- ``SyntheticLM`` batches with their patches and ``loss_mask`` (0 over
  the patch positions) bit-equal to the reference's; ``make_patches``
  from one seed equal; the config's plan; the ``proj`` leaves (1024 ->
  d, bf16 in a bf16 model) and the params tree against the port's own
  ``init_params``.
- ``loss_fn``: the loss, every metric and every gradient (``proj``'s
  included); three trainer steps.
- ``decode.prefill`` with patches (the fused path: the splice, then K/V
  written for every position) and three decode steps: the logits, the
  greedy tokens and the KV caches; a prompt shorter than the patches is
  refused.
- ``batching.pad_frontend_pack`` against the reference's, and
  ``ServingEngine.run`` with ``use_flash=True`` and per-request patches
  (one request without: zero patches): exactly the reference engine's
  greedy tokens.
- ``engine.generate(frontend=)`` against the reference's ``generate``:
  the same greedy tokens.
- K5's entry (the plain version CPU tensors take) at InternVL2's GQA 6:1
  with head dim 128, causal at a ragged length, against the reference's
  Pallas kernel in interpret mode.

float32 at ``reduced()`` size (2 layers, d 256, 4 heads of 64, 16
patches, vocab 512) on the reference's ``init_params`` weights; rtol =
atol = 1e-4.  The reference model is built once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase
from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.models import transformer as jtransformer
from repro.models import vlm as jvlm
from repro.serving import batching as jbatching
from repro.serving import engine as jengine
from repro_torch.configs import base
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models import model, transformer, vlm
from repro_torch.serving import batching, engine

from torch_family_checks import (batches, build, check_loss_and_grads,
                                 check_trainer_steps, close, prompts,
                                 serve_both, shapes)

torch.set_num_threads(2)

ARCH_ID = "internvl2_26b"
N_PATCH = 16                          # reduced() frontend_len


@pytest.fixture(scope="module")
def built(mesh11):
    return build(mesh11, ARCH_ID)


def test_patches_loss_mask_and_proj_match_reference(built):
    jctx, _, ctx, params = built
    arch = ctx.arch
    assert (arch.frontend, arch.frontend_len) == ("vision", N_PATCH)
    for step in (0, 3):
        b = batches(arch, jctx.arch, step)
        assert b["frontend"].shape == (4, N_PATCH, vlm.VIT_WIDTH)
        assert b["loss_mask"][:, :N_PATCH].max() == 0.0
        assert b["loss_mask"][:, N_PATCH:].min() == 1.0
    got = vlm.make_patches(np.random.default_rng(5), 2, arch)
    want = jvlm.make_patches(np.random.default_rng(5), 2, jctx.arch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = base.get_config(ARCH_ID)
    assert vlm.patch_shape(1, full) == (1, 256, 1024) == jvlm.patch_shape(
        1, jbase.get_config(ARCH_ID))
    assert [dataclasses.astuple(s) for s in
            transformer.layer_plan(arch)[1]] == [
        dataclasses.astuple(s) for s in
        jtransformer.layer_plan(jctx.arch)[1]] == [("attn", "mlp", False,
                                                     True)]
    own = model.init_params(ctx, torch.Generator().manual_seed(0), "cpu")
    assert shapes(params) == shapes(own)
    assert list(params) == list(own) == ["embed", "final_norm", "layers",
                                         "proj"]
    assert {k: tuple(v.shape) for k, v in params["proj"].items()} == {
        "w1": (vlm.VIT_WIDTH, 256), "w2": (256, 256)}
    ctx16 = model.build_ctx(dataclasses.replace(arch, dtype="bfloat16"),
                            device="cpu")
    own16 = model.init_params(ctx16, torch.Generator().manual_seed(0), "cpu")
    assert {v.dtype for v in own16["proj"].values()} == {torch.bfloat16}


def test_loss_metrics_and_grads_match_reference(mesh11, built):
    jctx, _, ctx, _ = built
    m = check_loss_and_grads(mesh11, built, batches(ctx.arch, jctx.arch))
    assert float(m["nll"].detach()) > 0.0


def test_trainer_steps_match_reference(mesh11, built):
    check_trainer_steps(mesh11, built)


def test_prefill_splice_and_decode_match_reference(built):
    """A right-padded pack of 3 prompts of 17-27 tokens with their patches
    in 4 rows (the fourth padded: zero patches over its one-token prompt
    and the pad), then three greedy decode steps."""
    jctx, jparams, ctx, params = built
    ps = prompts(ctx.arch.vocab_size, [20, 27, 17], seed=0)
    tok, lens = batching.pad_pack(ps, pack=4, buckets=(32,), device="cpu")
    fr = batching.pad_frontend_pack(
        list(vlm.make_patches(np.random.default_rng(2), 3, ctx.arch)), 4,
        "cpu")
    jlg, jcache = jax.jit(jengine.make_prefill(
        jctx, with_cache=True, cache_len=40))(
        jparams, {"tokens": jnp.asarray(tok.numpy()),
                  "lens": jnp.asarray(lens.numpy()),
                  "frontend": jnp.asarray(fr.numpy())})
    lg, cache = engine.make_prefill(ctx, with_cache=True, cache_len=40)(
        params, {"tokens": tok, "lens": lens, "frontend": fr})
    close(lg, jlg)
    # the patches change what follows them
    plain, _ = engine.make_prefill(ctx, with_cache=True, cache_len=40)(
        params, {"tokens": tok, "lens": lens})
    assert float((plain - lg).abs().max()) > 1e-2
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
    for i, layer in enumerate(cache):
        jlayer = jax.tree_util.tree_map(
            lambda a, g=i: a[g], jcache["groups"]["sub0"]["mixer"])
        assert set(layer) == {"mixer"}
        for k, v in jlayer.items():
            close(layer["mixer"][k], v)
    short, lens_s = batching.pad_pack([[1, 2, 3]], pack=1, buckets=(8,),
                                      device="cpu")
    with pytest.raises(ValueError, match="patch embeddings"):
        engine.make_prefill(ctx, with_cache=True, cache_len=40)(
            params, {"tokens": short, "lens": lens_s,
                     "frontend": fr[:1]})


SERVE_LENS, SERVE_BUDGETS = [19, 30, 23, 17, 32, 25], [4, 2, 6, 3, 5, 1]
SERVE_CFG = dict(num_slots=4, cache_len=40, prefill_pack=2,
                 prompt_buckets=(32,))


def test_serving_engine_with_patches_matches_reference(built):
    jctx, _, ctx, _ = built
    patches = [p.numpy() for p in vlm.make_patches(
        np.random.default_rng(4), len(SERVE_LENS), ctx.arch)]
    patches[2] = None
    got_pack = batching.pad_frontend_pack(patches[:3], 4, "cpu")
    want_pack = jbatching.pad_frontend_pack(patches[:3], 4)
    np.testing.assert_array_equal(got_pack.numpy(), np.asarray(want_pack))
    with pytest.raises(ValueError, match="disagree"):
        batching.pad_frontend_pack([patches[0], patches[0][:3]], 2, "cpu")
    want, got = serve_both(built, SERVE_CFG, SERVE_LENS, SERVE_BUDGETS,
                           frontends=patches,
                           ctx=dataclasses.replace(ctx, use_flash=True))
    for i in range(len(SERVE_LENS)):
        assert got.tokens_for(i) == want[i], i


def test_generate_with_patches_matches_reference(built):
    jctx, jparams, ctx, params = built
    rng = np.random.default_rng(9)
    tok = rng.integers(0, ctx.arch.vocab_size, size=(2, 24)).astype(np.int32)
    fr = vlm.make_patches(rng, 2, ctx.arch)
    want = jengine.generate(jparams, jctx, jnp.asarray(tok), steps=5,
                            cache_len=32, frontend=jnp.asarray(fr.numpy()))
    got = engine.generate(params, ctx, torch.from_numpy(tok), steps=5,
                          cache_len=32, frontend=fr)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    plain = engine.generate(params, ctx, torch.from_numpy(tok), steps=5,
                            cache_len=32)
    assert not torch.equal(plain.tokens, got.tokens)


def test_flash_entry_gqa_6_to_1_at_head_dim_128_matches_pallas():
    """InternVL2's prefill call of K5: 48 query heads over 8 KV heads at
    full width, here 12 over 2 (G = 6) of 128, causal, Sq = Sk = 72
    (blocks of 32: the last holds 8 rows)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 72, 12, 128)).astype(np.float32)
    k, v = (rng.standard_normal((1, 72, 2, 128)).astype(np.float32)
            for _ in range(2))
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, block_q=32,
                                  block_k=32, interpret=True)
    close(got, want)
