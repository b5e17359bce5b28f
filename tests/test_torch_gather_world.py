"""The gather transport and serving on an EP world against the JAX package.

One JAX subprocess on 4 forced host devices computes the reference:

- the ``gather`` engine through ``_moe_block(decode=True)`` on layer 1 of
  ``gpt3_medium_moe.reduced()`` (float32, 4 experts) on the mesh ``(2,
  2, 1)`` over ``("pod", "data", "model")``, with the tokens sharded over
  the ranks (the output, the metrics and the gradients of ``sum(y * r) +
  aux_loss``) and, ``decode_replicated``, on every rank (the output and
  the metrics);
- ``ServingEngine.run`` and ``generate`` on the ``(4, 1)`` data x model
  mesh that ``repro.launch.serve --devices 4 --mesh-shape 4,1`` builds,
  greedy.

Beside it, as soon as it has written the weights, batch and prompts
(``torch_world_reference``), 4 CPU processes of the port, joined over
gloo (one 2x2 world, ``launch.mesh.spawn``), run the same from the same
weights: each rank
gathers the world's tokens, runs its one expert on them and the partial
outputs are summed over the EP axes; the kernels wanted (the fused
``local_moe`` branch, its plain version on the CPU) and not.  The port's
einsum engine on the whole batch (capacity = every token, nothing drops)
is the oracle of the output.  The serving engine shards its 8 slots and
packs of 4 over the ranks, 2 slots and one pack row each.

Tolerance: rtol = atol = 1e-4 (float32, the sums run in another order);
greedy tokens exact.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH_ID = "gpt3_medium_moe"
SEQ, BATCH = 8, 8
SIZES = (2, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_KEYS = ("aux_loss", "frac_by_level", "frac_near", "frac_far",
               "dropped")
# ServingEngine: 10 requests of mixed lengths through 8 slots in packs of 4
SERVE = dict(num_slots=8, cache_len=32, prefill_pack=4,
             prompt_buckets=(8, 16))
PROMPT_LENS = (3, 8, 12, 5, 16, 1, 9, 7, 14, 4)
BUDGETS = (4, 6, 3, 9, 5, 2, 7, 8, 4, 6)
GEN_BATCH, GEN_PROMPT, GEN_STEPS, GEN_CACHE = 4, 6, 5, 16

REFERENCE = f"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import get_config
from repro.models import model, transformer
from repro.serving import engine
from repro.serving.scheduler import Request

arch = get_config("{ARCH_ID}").reduced()
mesh = make_mesh({SIZES + (1,)}, ("pod", "data", "model"))
ctx = model.build_ctx(arch, mesh, seq_len={SEQ}, global_batch={BATCH},
                      aux_mode="ta")
rules = model.default_rules(mesh)
with mesh, sharding.axis_rules(rules):
    params = model.init_params(jax.random.PRNGKey(0), ctx, rules=rules)
tree = jax.tree_util.tree_map(np.asarray, params)
rng = np.random.default_rng(5)
x = rng.standard_normal(({BATCH}, {SEQ}, arch.d_model)).astype(np.float32)
r = rng.standard_normal(x.shape).astype(np.float32)
smesh = make_mesh((4, 1), ("data", "model"))
sctx = model.build_ctx(arch, smesh, seq_len={SERVE["cache_len"]},
                       global_batch={SERVE["num_slots"]}, aux_mode="none")
srules = model.default_rules(smesh)
rng = np.random.default_rng(9)
prompts = [rng.integers(0, arch.vocab_size, size=n).tolist()
           for n in {PROMPT_LENS}]
gen_prompts = rng.integers(0, arch.vocab_size,
                           size=({GEN_BATCH}, {GEN_PROMPT})).astype(np.int32)
with smesh, sharding.axis_rules(srules):
    sparams = model.init_params(jax.random.PRNGKey(0), sctx, rules=srules)
inputs = {{"params": tree, "x": x, "r": r,
          "serve_params": jax.tree_util.tree_map(np.asarray, sparams),
          "prompts": prompts, "gen_prompts": gen_prompts}}
dump_inputs(inputs)
p1 = jax.tree_util.tree_map(lambda a: a[1], params["groups"])["sub0"]["ffn"]
gather = {{}}
for replicated in (False, True):
    c = dataclasses.replace(ctx, decode_replicated=replicated)

    def loss(p, xx, c=c):
        y, m = transformer._moe_block(p, xx, c, decode=True, layer_idx=1)
        return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)

    with mesh:
        (_, (y, m)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p1, jnp.asarray(x))
    gather[replicated] = {{
        "y": np.asarray(y),
        "metrics": {{k: np.asarray(v) for k, v in m.items()}},
        "grads": jax.tree_util.tree_map(np.asarray, g)}}

with smesh, sharding.axis_rules(srules):
    reqs = [Request(uid=i, tokens=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, {BUDGETS}))]
    rep = engine.ServingEngine(sparams, sctx,
                               engine.ServeConfig(**{SERVE})).run(reqs)
    res = engine.generate(sparams, sctx, jnp.asarray(gen_prompts),
                          steps={GEN_STEPS}, cache_len={GEN_CACHE})
with open(sys.argv[1], "wb") as f:
    pickle.dump({{**inputs, "gather": gather,
                 "served": {{i: rep.tokens_for(i)
                            for i in range(len(prompts))}},
                 "generated": np.asarray(res.tokens)}}, f)
"""


def _rank_main(world, ref_path, out_dir):
    """One rank of the 2x2 world: the gather engine (kernels wanted and
    not, tokens sharded and replicated) with its gradients, then serving:
    ``ServingEngine.run`` greedy and at temperature 0.8, and
    ``generate``.  Results go to ``rank<r>.pkl``."""

    torch.set_num_threads(1)
    from repro_torch.configs.base import get_config
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import Request

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    arch = get_config(ARCH_ID).reduced()
    per = BATCH // world.size
    rows = slice(world.rank * per, (world.rank + 1) * per)
    out = {"rank": world.rank, "coords": world.coords, "gather": {}}
    for use_pallas in (False, True):
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              aux_mode="ta", use_pallas=use_pallas,
                              device="cpu")
        params = params_from_numpy(ref["params"], ctx, "cpu")
        p = {k: (v.requires_grad_(True) if torch.is_tensor(v)
                 else {kk: vv.requires_grad_(True) for kk, vv in v.items()})
             for k, v in params["layers"][1]["ffn"].items()}
        x = torch.from_numpy(ref["x"][rows].copy()).requires_grad_(True)
        y, m = transformer._moe_block(p, x, ctx, decode=True, layer_idx=1)
        # this rank's part of sum(y * r) + pmean(aux): the aux loss keeps
        # this rank's own gradient (see transformer._world_mean)
        (torch.sum(y * torch.from_numpy(ref["r"][rows].copy()))
         + m["aux_loss"] / world.size).backward()
        out["gather"][use_pallas, False] = {
            "y": y.detach().numpy(),
            "metrics": {k: v.detach().numpy() for k, v in m.items()},
            "gx": x.grad.numpy(),
            "g_gate": world.all_reduce_sum(p["gate"]["w"].grad).numpy(),
            "g_w_in": p["w_in"].grad.numpy(),
            "g_w_out": p["w_out"].grad.numpy()}
        # the tokens on every rank already: no gather, no slice
        with torch.no_grad():
            y, m = transformer._moe_block(
                p, torch.from_numpy(ref["x"].copy()),
                dataclasses.replace(ctx, decode_replicated=True),
                decode=True, layer_idx=1)
        out["gather"][use_pallas, True] = {
            "y": y.numpy(),
            "metrics": {k: v.numpy() for k, v in m.items()}}

    sctx = model.build_ctx(arch, world, seq_len=SERVE["cache_len"],
                           global_batch=SERVE["num_slots"], aux_mode="none",
                           device="cpu")
    sparams = params_from_numpy(ref["serve_params"], sctx, "cpu")
    out["serve_expert_range"] = sctx.expert_range
    eng = engine.ServingEngine(sparams, sctx, engine.ServeConfig(**SERVE))
    for temp in (0.0, 0.8):
        reqs = [Request(uid=i, tokens=p, max_new_tokens=m, temperature=temp)
                for i, (p, m) in enumerate(zip(ref["prompts"], BUDGETS))]
        rep = eng.run(reqs, seed=3)
        out["served", temp] = {i: rep.tokens_for(i)
                               for i in range(len(reqs))}
        out["steps", temp] = (rep.decode_steps, rep.prefill_calls)
    # a deadline of 0 s: evicted after its first token, on every rank
    reqs = [Request(uid=i, tokens=p, max_new_tokens=m,
                    deadline_s=0.0 if i == 2 else None)
            for i, (p, m) in enumerate(zip(ref["prompts"], BUDGETS))]
    rep = eng.run(reqs)
    out["deadline"] = ({i: rep.tokens_for(i) for i in range(len(reqs))},
                       rep.evictions)
    res = engine.generate(sparams, sctx,
                          torch.from_numpy(ref["gen_prompts"].copy()),
                          steps=GEN_STEPS, cache_len=GEN_CACHE)
    out["generated"] = res.tokens.numpy()
    with open(os.path.join(out_dir, f"rank{world.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0..3 results]) — one JAX subprocess and,
    beside it once it has made the weights, batch and prompts, one
    4-process gloo world of the port."""
    from repro_torch.launch import mesh
    from torch_world_reference import run_beside_world
    tmp = tmp_path_factory.mktemp("gather_world")
    ref = run_beside_world(
        REFERENCE, 4, tmp,
        lambda inputs: mesh.spawn(_rank_main, SIZES, "gloo", "cpu",
                                  args=(inputs, str(tmp))))
    ranks = []
    for i in range(4):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _stack(ranks, key, field, replicated):
    """The world's output: the ranks' rows in rank order (the same rows
    on every rank when the tokens were replicated)."""
    if replicated:
        for out in ranks[1:]:
            close(out["gather"][key][field], ranks[0]["gather"][key][field])
        return ranks[0]["gather"][key][field]
    return np.concatenate([out["gather"][key][field] for out in ranks])


@pytest.mark.parametrize("replicated", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gather_engine_matches_reference_and_oracle(runs, use_pallas,
                                                    replicated):
    """Output and world-mean metrics against the reference; the output
    also against the einsum oracle on the whole batch."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.dispatch import base, engine
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    ref, ranks = runs
    want = ref["gather"][replicated]
    key = (use_pallas, replicated)
    y = _stack(ranks, key, "y", replicated)
    close(y.reshape(want["y"].shape), want["y"])
    for out in ranks:
        assert set(out["gather"][key]["metrics"]) == set(METRIC_KEYS)
        for k in METRIC_KEYS:
            close(out["gather"][key]["metrics"][k], want["metrics"][k])
        assert float(out["gather"][key]["metrics"]["dropped"]) == 0.0
    arch = get_config(ARCH_ID).reduced()
    ctx = model.build_ctx(arch, seq_len=SEQ, global_batch=BATCH,
                          aux_mode="ta", device="cpu")
    p = params_from_numpy(ref["params"], ctx, "cpu")["layers"][1]["ffn"]
    T = BATCH * SEQ
    # the oracle's gate has no levels: its aux loss is lb's (y is the same)
    oracle = engine.make_engine(
        "einsum", cfg=ctx.moe_cfg, ep=base.EPSpec(),
        gate_cfg=dataclasses.replace(ctx.gate_cfg, aux_mode="lb"),
        capacity=T)
    with torch.no_grad():
        y_or, m_or = oracle(p, torch.from_numpy(
            ref["x"].reshape(T, -1).copy()))
    assert float(m_or["dropped"]) == 0.0
    close(y.reshape(T, -1), y_or.numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gather_engine_grads_match_reference(runs, use_pallas):
    """Through the gather's backward (the sum over the axis, this rank's
    rows) and the partial sums' (the same sum): the input's, the gate's
    (summed over the ranks) and each rank's expert's gradients."""
    ref, ranks = runs
    g = ref["gather"][False]["grads"]
    key = (use_pallas, False)
    gx = _stack(ranks, key, "gx", False)
    close(gx.reshape(g[1].shape), g[1])
    for out in ranks:
        close(out["gather"][key]["g_gate"], g[0]["gate"]["w"])
    for k in ("w_in", "w_out"):
        close(np.concatenate([out["gather"][key][f"g_{k}"]
                              for out in ranks]), g[0][k])


def test_serving_engine_tokens_match_reference(runs):
    """``ServingEngine.run`` on the world, greedy: every rank's streams
    hold the reference engine's tokens on the (4, 1) mesh, exactly; each
    rank holds its own expert."""
    ref, ranks = runs
    for r, out in enumerate(ranks):
        assert out["serve_expert_range"] == (r, r + 1)
        assert out["served", 0.0] == ref["served"]
    assert sum(len(v) for v in ref["served"].values()) == sum(BUDGETS)


def test_sampling_agrees_across_ranks(runs):
    """At temperature 0.8 every rank samples the gathered logits with the
    same generator: the ranks' streams and step counts are the same."""
    _, ranks = runs
    for out in ranks[1:]:
        assert out["served", 0.8] == ranks[0]["served", 0.8]
        assert out["steps", 0.8] == ranks[0]["steps", 0.8]
    assert ([len(v) for v in ranks[0]["served", 0.8].values()]
            == list(BUDGETS))


def test_deadline_evictions_agree_across_ranks(runs):
    """A request with a 0 s deadline is evicted after the token its
    prefill gives, on every rank (the overdue slots are agreed by one
    all-reduce); the other streams keep the greedy tokens."""
    ref, ranks = runs
    for out in ranks:
        streams, evictions = out["deadline"]
        assert evictions == 1
        assert streams[2] == ref["served"][2][:1]
        assert {i: v for i, v in streams.items() if i != 2} == {
            i: v for i, v in ref["served"].items() if i != 2}


def test_generate_matches_reference(runs):
    """``generate`` on the world: every rank returns the whole batch's
    greedy tokens, the reference's."""
    ref, ranks = runs
    for out in ranks:
        np.testing.assert_array_equal(out["generated"], ref["generated"])


def test_serve_launcher_spawns_a_world(capfd):
    """``launch/serve.py --devices 4 --mesh-shape 4,1 --device cpu``: four
    gloo ranks serve the streams (then ``generate``), rank 0 reports."""
    from repro_torch.launch import serve
    common = ["--arch", ARCH_ID, "--reduced", "--device", "cpu",
              "--devices", "4", "--mesh-shape", "4,1", "--batch", "4",
              "--prompt-len", "4", "--steps", "3", "--cache-len", "16"]
    assert serve.main(common + ["--streams", "4"]) == 0
    assert serve.main(common) == 0
    out = capfd.readouterr().out
    assert out.count("served 4 streams") == 1
    assert out.count("generated (4, 3) tokens") == 1


def test_serve_launcher_refuses_a_model_axis(capsys):
    """``--mesh-shape 1,3`` names a model axis of 3, which reduced
    DeepSeek-V2's 4 MLA heads do not divide: refused before any rank is
    spawned, by the heads' leaves; ``tests/test_torch_tensor_parallel.py``
    and ``test_torch_tensor_parallel_families.py`` serve on a model axis
    of 2."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "deepseek_v2_lite_16b", "--reduced",
                    "--device", "cpu", "--devices", "3", "--mesh-shape",
                    "1,3"])
    err = capsys.readouterr().err
    assert "model axis 3" in err and "MLA's 4 heads" in err


def test_serving_refuses_slots_that_do_not_divide():
    """``num_slots`` and ``prefill_pack`` must divide over the world: a
    count that does not is refused by name, before any collective."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model
    from repro_torch.serving import engine
    world = EPWorld(axis_names=("pod", "data"), axis_sizes=SIZES,
                    coords=(0, 1), device="cpu")
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), world,
                          seq_len=32, global_batch=8, aux_mode="none",
                          device="cpu")
    for cfg, name in ((dict(num_slots=6, prefill_pack=4), "num_slots 6"),
                      (dict(num_slots=8, prefill_pack=2), "prefill_pack 2")):
        with pytest.raises(ValueError, match=name):
            engine.ServingEngine(None, ctx, engine.ServeConfig(
                cache_len=32, prompt_buckets=(8,), **cfg))
