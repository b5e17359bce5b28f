"""Parity of the port's serving layer with the JAX package on the CPU:
``decode_step`` over three steps after a packed prefill, the slotted cache
operations, and ``ServingEngine.run`` on six requests of mixed lengths at
temperature 0, which must give exactly the JAX engine's greedy tokens —
through the port's unfused gather branch (auto on the CPU) and its fused
branch (``use_pallas=True``, whose kernel entry runs its plain version on
the CPU).

Same weights on both sides (``params_from_numpy``), the reduced
``gpt3_medium_moe`` in float32; logits are compared at 1e-3 abs (float32
sums over 512 vocabulary rows in another order), caches at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import engine as jengine
from repro.serving.scheduler import Request as JRequest
from repro_torch.kernels import backend
from repro_torch.models import decode
from repro_torch.serving import batching, engine
from repro_torch.serving.scheduler import Request, Scheduler
from test_torch_model import LOGIT_ATOL, build_ctxs, build_params, close

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(mesh11, key):
    jparams, params = build_params(mesh11, key)
    jctx, ctx = build_ctxs(mesh11, aux_mode="none")
    return jctx, jparams, ctx, params


def prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def test_decode_steps_match_jax(setup):
    jctx, jparams, ctx, params = setup
    ps = prompts(ctx.arch.vocab_size, [5, 11, 2], seed=0)
    cache_len = 24
    jtok, jlens = (jnp.asarray(np.asarray(a)) for a in batching.pad_pack(
        ps, pack=4, buckets=(16,), device="cpu"))
    jpre = jax.jit(jengine.make_prefill(jctx, with_cache=True,
                                        cache_len=cache_len))
    jstep = jax.jit(jengine.make_decode_step(jctx))
    jlg, jcache = jpre(jparams, {"tokens": jtok, "lens": jlens})
    tok, lens = batching.pad_pack(ps, pack=4, buckets=(16,), device="cpu")
    lg, cache = engine.make_prefill(ctx, with_cache=True,
                                    cache_len=cache_len)(
        params, {"tokens": tok, "lens": lens})
    close(lg, jlg, rtol=0, atol=LOGIT_ATOL)
    step = engine.make_decode_step(ctx)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(
            np.asarray(torch.argmax(lg, dim=-1))[:, None], nxt)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(nxt))
        lg, cache = step(params, cache, torch.from_numpy(nxt))
        jlg, lg = jlg[:, 0], lg[:, 0]
        close(lg, jlg, rtol=0, atol=LOGIT_ATOL)
    jc = jcache["groups"]["sub0"]["mixer"]
    for i, layer in enumerate(cache):
        for name in ("k", "v", "pos"):
            close(layer["mixer"][name], np.asarray(jc[name])[i])


def test_slot_cache_insert_drops_padded_ids_and_evicts(setup):
    _, _, ctx, params = setup
    kv = batching.SlotKVCache(ctx, num_slots=3, cache_len=8)
    src = decode.init_cache(ctx, 2, 8, device="cpu")
    for layer in src:
        layer["mixer"]["k"].fill_(1.0)
        layer["mixer"]["pos"].fill_(5)
    kv.insert(src, np.asarray([2, 3]))            # id 3 == num_slots: dropped
    np.testing.assert_array_equal(kv.positions(), [0, 0, 5])
    assert float(kv.cache[1]["mixer"]["k"][2].min()) == 1.0
    assert float(kv.cache[1]["mixer"]["k"][:2].abs().max()) == 0.0
    kv.evict([2])
    np.testing.assert_array_equal(kv.positions(), [0, 0, 0])
    assert float(kv.cache[0]["mixer"]["k"].abs().max()) == 0.0


def test_scheduler_is_the_reference_scheduler():
    from repro.serving.scheduler import Scheduler as JScheduler
    trace = []
    for cls, req in ((Scheduler, Request), (JScheduler, JRequest)):
        s = cls(num_slots=2)
        for i, budget in enumerate([1, 3, 2]):
            s.submit(req(uid=i, tokens=[5], max_new_tokens=budget))
        got = [slot for slot, _ in s.take(3, now=0.0)]
        s.on_token(got[0], 4)
        s.complete(got[0], now=1.0)
        got += [slot for slot, _ in s.take(3, now=1.0)]
        trace.append((got, [st.request.uid for st in s.finished]))
    assert trace[0] == trace[1]


@pytest.fixture(scope="module")
def jax_served(setup):
    jctx, jparams, ctx, _ = setup
    lens = [3, 14, 7, 1, 16, 9]
    budgets = [4, 2, 6, 3, 5, 1]
    ps = prompts(ctx.arch.vocab_size, lens, seed=3)
    cfg = dict(num_slots=4, cache_len=24, prefill_pack=2,
               prompt_buckets=(8, 16))
    rep = jengine.ServingEngine(jparams, jctx, jengine.ServeConfig(**cfg)).run(
        [JRequest(uid=i, tokens=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(ps, budgets))])
    return ps, budgets, cfg, rep


@pytest.mark.parametrize("use_pallas", [None, True])
def test_serving_engine_greedy_tokens_match_jax(setup, jax_served,
                                                use_pallas):
    _, _, ctx, params = setup
    ps, budgets, cfg, jrep = jax_served
    ctx = dataclasses.replace(ctx, use_pallas=use_pallas)
    backend.reset_launches()
    rep = engine.ServingEngine(params, ctx, engine.ServeConfig(**cfg)).run(
        [Request(uid=i, tokens=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(ps, budgets))])
    assert rep.total_new_tokens == jrep.total_new_tokens == sum(budgets)
    assert (rep.prefill_calls, rep.decode_steps) == \
        (jrep.prefill_calls, jrep.decode_steps)
    for i in range(len(ps)):
        assert rep.tokens_for(i) == [int(v) for v in jrep.tokens_for(i)], i
    assert all(n == 0 for n in backend.LAUNCHES.values())   # CPU: plain


def test_deadline_eviction_frees_the_slot(setup):
    """A stream past its deadline is evicted with its partial output and
    its slot (cache rows zeroed) serves the next request."""
    _, _, ctx, params = setup
    eng = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=1, cache_len=16, prefill_pack=1, prompt_buckets=(8,)))
    rep = eng.run([Request(uid=0, tokens=[1, 2, 3], max_new_tokens=10,
                           deadline_s=0.0),
                   Request(uid=1, tokens=[4, 5], max_new_tokens=2)])
    first = next(s for s in rep.streams if s.request.uid == 0)
    assert rep.evictions == 1 and first.evicted
    assert 1 <= len(first.generated) < 10
    assert len(rep.tokens_for(1)) == 2


def test_generate_matches_serving(setup):
    _, _, ctx, params = setup
    p = prompts(ctx.arch.vocab_size, [6], seed=4)[0]
    res = engine.generate(params, ctx, torch.tensor([p], dtype=torch.int32),
                          steps=4, cache_len=16)
    rep = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=2, cache_len=16, prefill_pack=1, prompt_buckets=(8,))).run(
        [Request(uid=0, tokens=p, max_new_tokens=4)])
    assert res.tokens[0].tolist() == rep.tokens_for(0)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "gpt3_medium_moe", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4",
                       "--steps", "3", "--cache-len", "16",
                       "--streams", "3"]) == 0
    assert "served 3 streams" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gpt3_medium_moe", "--devices", "4"])


@pytest.mark.parametrize("override", [None, ((1, "a2a_pipelined"),),
                                      ((0, "einsum"),)])
def test_logits_only_prefill_matches_jax(mesh11, setup, override):
    """``make_prefill(with_cache=False)``: last-position logits through
    ``transformer.forward`` on the a2a path (and with a serving-side
    per-layer override: a pipelined layer gets the overlap model's chunk
    count, as the reference's ``_with_overrides`` gives it), against the
    reference's at LOGIT_ATOL."""
    from repro.configs.base import get_config as jax_get_config
    from repro.models import model as jmodel
    from repro_torch.models import model
    _, jparams, ctx0, params = setup
    jctx = jmodel.build_ctx(jax_get_config("gpt3_medium_moe").reduced(),
                            mesh11, seq_len=16, global_batch=4,
                            aux_mode="none")
    ctx = model.build_ctx(ctx0.arch, seq_len=16, global_batch=4,
                          aux_mode="none", device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, ctx.arch.vocab_size, size=(4, 16)).astype(
        np.int32)
    want = jax.jit(jengine.make_prefill(jctx, override))(
        jparams, {"tokens": jnp.asarray(tokens)})
    got = engine.make_prefill(ctx, override)(
        params, {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (4, ctx.arch.vocab_size)
    close(got, want, rtol=0, atol=LOGIT_ATOL)
