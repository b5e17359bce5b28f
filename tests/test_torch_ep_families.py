"""The repo's other two MoE models on the paper's expert-parallel 2x2
world (pod x data) against the JAX package.

One JAX subprocess on 4 forced host devices (mesh ``(2, 2, 1)`` over
``("pod", "data", "model")``, as ``tests/test_torch_multirank.py`` runs
it) computes the reference, with ``aux_mode="ta"``:

- DeepSeek-V2-Lite ``reduced()`` widened to 8 experts (2 a rank), top-6
  and 2 shared experts, at 3 layers (a dense first layer, then two MoE
  layers; MLA in every one): through ``_moe_block`` on each MoE layer,
  the output, the metrics and the gradients of ``sum(y * r) + aux_loss``
  (the shared experts' leaves among them); ``loss_fn`` on a batch with
  a loss mask, its metrics and every gradient; 3 trainer steps through
  ``a2a`` and 3 through ``a2a_pipelined`` at 2 chunks over the ``int8``
  wire (kernel branch); ``ServingEngine.run`` greedy on the ``(4, 1)``
  data x model mesh that ``repro.launch.serve --mesh-shape 4,1`` builds
  (every MoE layer through ``gather``, MLA's latent cache in the slots);
- Jamba ``reduced()`` with 8 experts, cut to the fewest layers that hold
  each sublayer kind (a Mamba layer with a dense FFN, then attention with
  the MoE FFN): 3 trainer steps through ``a2a`` and ``ServingEngine.run``
  greedy (Mamba's state in the slots, the scan prefill).

Beside it, as soon as it has written the weights and batches
(``torch_world_reference``), 4 CPU processes of the port, joined over
gloo (one 2x2 world, ``launch.mesh.spawn``), run the same from the same
weights, each with its 2 experts a layer, the kernels wanted (their
plain versions on the CPU) and not.  Top-6 of 8 on this plan drops
picks at both stages: the Eq. (7) per-level capacities are live.
``reference`` and ``rank_main`` build both sides for any set of models;
``tests/test_torch_ep_deepseek_236b.py`` runs DeepSeek-V2-236B through
them in a fixture of its own.

Tolerance: rtol = atol = 1e-4 for outputs, metrics, gradients and
histories (float32, the sums run in another order); final params atol
2e-4 (``test_torch_training.py``).  Under the int8 wire a value the two
frameworks sum in another order can decode one wire level apart
(``tests/test_torch_pipelined.py``, ``close_but_flips``): the pipelined
histories take ``TOL`` plus 1e-3 of each value, the final params ``TOL``
but for 0.1% of the weights, which may differ by 2 lr (a gradient near 0
whose sign a flipped value turns).  Greedy tokens exact.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SIZES = (2, 2)
SEQ, BATCH, STEPS = 32, 8, 3
TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_KEYS = ("aux_loss", "frac_by_level", "frac_near", "frac_far",
               "dropped")
HISTORY_KEYS = ("loss", "nll", "aux", "frac_by_level", "dropped",
                "grad_norm", "lr")
PIPELINED_CHUNKS = 2
LR = 3e-4
# the architectures, as text both packages evaluate on their own configs
DSV2 = ("dataclasses.replace(get_config('deepseek_v2_lite_16b').reduced(), "
        "num_layers=3, moe=dataclasses.replace(get_config("
        "'deepseek_v2_lite_16b').reduced().moe, num_experts=8, top_k=6, "
        "num_shared_experts=2))")
JAMBA = ("dataclasses.replace(get_config('jamba_v0_1_52b').reduced(), "
         "num_layers=2, attn_every=2, attn_offset=1, moe=dataclasses.replace("
         "get_config('jamba_v0_1_52b').reduced().moe, num_experts=8, "
         "moe_period=2))")
ARCHS = {"dsv2": DSV2, "jamba": JAMBA}
# ServingEngine: 10 requests of mixed lengths through 8 slots in packs of 4
SERVE = dict(num_slots=8, cache_len=32, prefill_pack=4,
             prompt_buckets=(8, 16))
PROMPT_LENS = (3, 8, 12, 5, 16, 1, 9, 7, 14, 4)
BUDGETS = (4, 6, 3, 9, 5, 2, 7, 8, 4, 6)
MOE_LAYERS = (1, 2)

def reference(archs: dict, moe: str, seed: int, picks: bool = False,
              int8: bool = False) -> str:
    """The reference's script for the 2x2 world: the models of ``archs``
    (key -> architecture text) with their weights, a masked batch and
    prompts each from ``np.random.default_rng(seed)``; ``moe``'s MoE
    layers through ``_moe_block`` (with ``picks``, also every rank's
    top-k picks and dispatch indices), its ``loss_fn`` and every
    gradient; 3 ``a2a`` trainer steps of each model (with ``int8``, 3
    more of ``moe`` through ``a2a_pipelined`` over the int8 wire); greedy
    ``ServingEngine.run`` of each on the (4, 1) mesh."""
    picks_text = f"""
    def picks(gate, xl):
        xl = xl.reshape(-1, xl.shape[-1])
        routed = routing.route({{"gate": gate}}, xl, ctx.moe_cfg, ctx.ep,
                               ctx.plan, ctx.gate_cfg, with_bufs=False)
        di = routing.build_indices(routed.sels, routed.gate_out["topk_idx"],
                                   xl.shape[0])
        return (routed.gate_out["topk_idx"][None], di.slot_to_token[None],
                di.inv_idx[None])

    with mesh:
        got = jax.jit(shard_map(picks, mesh=mesh,
                                in_specs=(P(), P(("pod", "data"), None,
                                                 None)),
                                out_specs=(P(("pod", "data")),) * 3,
                                check_vma=False))(p["gate"], jnp.asarray(x))
    out["picks", layer] = [np.asarray(a) for a in got]
""" if picks else ""
    int8_text = f"""
res = trainer.train(archs[{moe!r}], RunConfig(
    dispatch="a2a_pipelined", a2a_num_chunks={PIPELINED_CHUNKS},
    wire_codec="int8", use_pallas=True, **base), mesh, steps={STEPS},
    log_every=1, verbose=False)
out["train_int8"] = {{"history": res.metrics_history,
                     "final": jax.tree_util.tree_map(np.asarray,
                                                     res.params)}}
""" if int8 else ""
    archs_text = ", ".join(f"{k!r}: {v}" for k, v in archs.items())
    return f"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import sharding
from repro.compat import make_mesh, shard_map
from repro.configs.base import RunConfig, get_config
from repro.core.dispatch import routing
from repro.models import model, transformer
from repro.serving import engine
from repro.serving.scheduler import Request
from repro.training import trainer

mesh = make_mesh({SIZES + (1,)}, ("pod", "data", "model"))
smesh = make_mesh((4, 1), ("data", "model"))
rules, srules = model.default_rules(mesh), model.default_rules(smesh)
archs = {{{archs_text}}}
rng = np.random.default_rng({seed})
inputs, built = {{}}, {{}}
for k, arch in archs.items():
    ctx = model.build_ctx(arch, mesh, seq_len={SEQ}, global_batch={BATCH},
                          aux_mode="ta")
    sctx = model.build_ctx(arch, smesh, seq_len={SERVE["cache_len"]},
                           global_batch={SERVE["num_slots"]},
                           aux_mode="none")
    with mesh, sharding.axis_rules(rules):
        params = model.init_params(jax.random.PRNGKey(0), ctx, rules=rules)
    with smesh, sharding.axis_rules(srules):
        sparams = model.init_params(jax.random.PRNGKey(0), sctx,
                                    rules=srules)
    toks = rng.integers(0, arch.vocab_size, size=({BATCH}, {SEQ} + 1))
    prompts = [rng.integers(0, arch.vocab_size, size=n).tolist()
               for n in {PROMPT_LENS}]
    inputs[k] = {{
        "params": jax.tree_util.tree_map(np.asarray, params),
        "serve_params": jax.tree_util.tree_map(np.asarray, sparams),
        "batch": {{"tokens": toks[:, :-1].astype(np.int32),
                  "labels": toks[:, 1:].astype(np.int32),
                  "loss_mask": (rng.random(({BATCH}, {SEQ})) > 0.1).astype(
                      np.float32)}},
        "prompts": prompts}}
    built[k] = (ctx, params, sctx, sparams)
x = rng.standard_normal(({BATCH}, {SEQ}, archs[{moe!r}].d_model)).astype(
    np.float32)
r = rng.standard_normal(x.shape).astype(np.float32)
inputs["x"], inputs["r"] = x, r
dump_inputs(inputs)

out = {{"caps": {{}}}}
ctx, params, _, _ = built[{moe!r}]
for layer in {MOE_LAYERS}:
    p = jax.tree_util.tree_map(lambda a: a[layer - 1],
                               params["groups"])["sub0"]["ffn"]
{picks_text}
    def loss(p, xx, layer=layer):
        y, m = transformer._moe_block(p, xx, ctx, decode=False,
                                      layer_idx=layer)
        return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)

    with mesh:
        (_, (y, m)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    out["moe", layer] = {{
        "y": np.asarray(y), "metrics": {{k: np.asarray(v)
                                         for k, v in m.items()}},
        "grads": jax.tree_util.tree_map(np.asarray, g)}}
jb = {{k: jnp.asarray(v) for k, v in inputs[{moe!r}]["batch"].items()}}
with mesh, sharding.axis_rules(rules):
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p: transformer.loss_fn(p, jb, ctx), has_aux=True))(params)
out["loss"] = {{"loss": np.asarray(loss),
               "metrics": {{k: np.asarray(v) for k, v in m.items()}},
               "grads": jax.tree_util.tree_map(np.asarray, g)}}

base = dict(seq_len={SEQ}, global_batch={BATCH}, warmup_steps=1,
            aux_mode="ta", seed=0)
for k, arch in archs.items():
    out["caps"][k] = built[k][0].plan.caps
    res = trainer.train(arch, RunConfig(dispatch="a2a", **base), mesh,
                        steps={STEPS}, log_every=1, verbose=False)
    out["train", k] = {{"history": res.metrics_history,
                       "final": jax.tree_util.tree_map(np.asarray,
                                                       res.params)}}
{int8_text}
for k in archs:
    _, _, sctx, sparams = built[k]
    with smesh, sharding.axis_rules(srules):
        reqs = [Request(uid=i, tokens=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(inputs[k]["prompts"],
                                               {BUDGETS}))]
        rep = engine.ServingEngine(sparams, sctx,
                                   engine.ServeConfig(**{SERVE})).run(reqs)
    out["served", k] = {{i: rep.tokens_for(i) for i in range(len(reqs))}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _arch(text):
    import dataclasses  # noqa: F401 (the texts name it)
    from repro_torch.configs.base import get_config  # noqa: F401
    return eval(text)


def _full_grads(world, params, ctx):
    """The synced gradient tree with the expert leaves all-gathered over
    the EP axes: the global tree on every rank."""
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    grads, _ = trainer.sync_grads(params, ctx)
    mask = trainer.expert_mask(params, ctx)
    leaves = [world.all_gather(t.contiguous(), ctx.ep.axis_names) if e
              else t for t, e in zip(adamw.tree_leaves(grads), mask)]
    return [t.detach().numpy() for t in leaves]


def mixer_leaves(params, names):
    """``[(layer, leaf name)]`` of the mixers' leaves named in ``names``,
    and one bool a leaf (``adamw.tree_leaves`` order): whether it is one
    of them."""
    from repro_torch import sharding
    paths = [p for p, _ in sharding._leaves_with_paths(params)]
    is_named = [len(p) > 3 and p[0] == "layers" and p[2] == "mixer"
                and p[3] in names for p in paths]
    return [(p[1], p[3]) for p, q in zip(paths, is_named) if q], is_named


def rank_main(world, ref_path, out_dir, archs, moe, picks=False,
              int8=False, local_leaves=()):
    """One rank of the 2x2 world, as ``reference(archs, moe, ...)`` runs
    the reference: ``moe``'s MoE layers (kernels wanted and not; with
    ``picks``, its top-k picks and dispatch indices), its loss and every
    synced gradient (with each rank's own gradient of the mixer leaves
    named in ``local_leaves`` and ``trainer.expert_mask``), the trainers
    (kernels auto and wanted) and each model's serving; its results go to
    ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.dispatch import routing
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import Request
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    per = BATCH // world.size
    rows = slice(world.rank * per, (world.rank + 1) * per)
    out = {"rank": world.rank, "coords": world.coords, "caps": {},
           "expert_range": {}}
    arch = _arch(archs[moe])
    for use_pallas in (False, True):
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              aux_mode="ta", use_pallas=use_pallas,
                              device="cpu")
        params = params_from_numpy(ref[moe]["params"], ctx, "cpu")
        for layer in MOE_LAYERS:
            p = {k: (v.requires_grad_(True) if torch.is_tensor(v)
                     else {kk: vv.requires_grad_(True)
                           for kk, vv in v.items()})
                 for k, v in params["layers"][layer]["ffn"].items()}
            x = torch.from_numpy(ref["x"][rows].copy()).requires_grad_(True)
            if picks and not use_pallas:
                flat = x.detach().reshape(-1, arch.d_model)
                routed = routing.route(p, flat, ctx.moe_cfg, ctx.ep,
                                       ctx.plan, ctx.gate_cfg, world.coords)
                di = routing.build_indices(
                    routed.sels, routed.gate_out["topk_idx"], flat.shape[0])
                out["picks", layer] = [
                    t.numpy() for t in (routed.gate_out["topk_idx"],
                                        di.slot_to_token, di.inv_idx)]
            y, m = transformer._moe_block(p, x, ctx, decode=False,
                                          layer_idx=layer)
            (torch.sum(y * torch.from_numpy(ref["r"][rows].copy()))
             + m["aux_loss"] / world.size).backward()
            grads = {k: (world.all_reduce_sum(v.grad)
                         if k not in ("w_in", "w_gate", "w_out")
                         else v.grad.clone()).numpy()
                     for k, v in p.items() if torch.is_tensor(v)}
            grads["gate"] = world.all_reduce_sum(p["gate"]["w"].grad).numpy()
            out["moe", layer, use_pallas] = {
                "y": y.detach().numpy(),
                "metrics": {k: v.detach().numpy() for k, v in m.items()},
                "gx": x.grad.numpy(), "grads": grads}
        batch = {k: torch.from_numpy(v[rows].copy())
                 for k, v in ref[moe]["batch"].items()}
        params = params_from_numpy(ref[moe]["params"], ctx, "cpu")
        leaves = adamw.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, m = transformer.loss_fn(params, batch, ctx)
        (loss / world.size).backward()
        _, named = mixer_leaves(params, local_leaves)
        out["loss", use_pallas] = {
            "metrics": world.mean(m),
            "local": [t.grad.clone().numpy()
                      for t, q in zip(leaves, named) if q],
            "expert_mask": trainer.expert_mask(params, ctx),
            "grads": _full_grads(world, params, ctx)}

    def train(key, **kw):
        arch = _arch(archs[key])
        run = RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                        aux_mode="ta", seed=0, **kw)
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              aux_mode="ta", dispatch=run.dispatch,
                              a2a_num_chunks=run.a2a_num_chunks,
                              wire_codec=run.wire_codec, device="cpu")
        out["caps"][key] = ctx.plan.caps
        out["expert_range"][key] = ctx.expert_range
        res = trainer.train(arch, run, world, steps=STEPS, log_every=1,
                            verbose=False,
                            params=params_from_numpy(ref[key]["params"], ctx,
                                                     "cpu"), device="cpu")
        return {"history": res.metrics_history, "chunks": ctx.a2a_num_chunks,
                "final": [t.detach().numpy()
                          for t in adamw.tree_leaves(res.params)]}

    for use_pallas in (None, True):
        for key in archs:
            out["train", key, use_pallas] = train(
                key, dispatch="a2a", use_pallas=use_pallas)
    if int8:
        out["train_int8"] = train(
            moe, dispatch="a2a_pipelined", a2a_num_chunks=PIPELINED_CHUNKS,
            wire_codec="int8", use_pallas=True)
    for key in archs:
        arch = _arch(archs[key])
        sctx = model.build_ctx(arch, world, seq_len=SERVE["cache_len"],
                               global_batch=SERVE["num_slots"],
                               aux_mode="none", device="cpu")
        sparams = params_from_numpy(ref[key]["serve_params"], sctx, "cpu")
        reqs = [Request(uid=i, tokens=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(ref[key]["prompts"],
                                               BUDGETS))]
        rep = engine.ServingEngine(sparams, sctx,
                                   engine.ServeConfig(**SERVE)).run(reqs)
        out["served", key] = {i: rep.tokens_for(i) for i in range(len(reqs))}
        out["serve_expert_range", key] = sctx.expert_range
    with open(os.path.join(out_dir, f"rank{world.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(tmp, archs, moe, seed, picks=False, int8=False,
              local_leaves=()):
    """(reference results, [rank 0..3 results]) of ``reference(archs, moe,
    seed, picks, int8)`` and, beside it once it has made the weights,
    batches and prompts, one 4-process gloo world of the port
    (``rank_main``)."""
    from repro_torch.launch import mesh
    from torch_world_reference import run_beside_world
    ref = run_beside_world(
        reference(archs, moe, seed, picks, int8), 4, tmp,
        lambda inputs: mesh.spawn(rank_main, SIZES, "gloo", "cpu",
                                  args=(inputs, str(tmp), archs, moe, picks,
                                        int8, tuple(local_leaves))))
    ranks = []
    for i in range(4):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0..3 results]) — one JAX subprocess and,
    beside it once it has made both models' weights, batches and prompts,
    one 4-process gloo world of the port."""
    return run_world(tmp_path_factory.mktemp("ep_families"), ARCHS, "dsv2",
                     5, int8=True)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _ref_leaves(text, tree, world=None):
    """A reference tree in the port's leaf order for the architecture
    ``text`` (``world``'s rank's expert slice, or every expert without a
    world)."""
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    ctx = model.build_ctx(_arch(text), world, seq_len=SEQ,
                          global_batch=BATCH, device="cpu")
    return [t.numpy() for t in adamw.tree_leaves(
        params_from_numpy(tree, ctx, "cpu"))]


def _world(out):
    from repro_torch.launch.mesh import EPWorld
    return EPWorld(axis_names=("pod", "data"), axis_sizes=SIZES,
                   coords=out["coords"])


def test_world_layout_and_top6_plan(runs):
    """Rank r sits at row-major (pod, data) coordinates and holds experts
    2r and 2r + 1 of both families, training and serving; the plans are
    the reference's, with both stages live."""
    ref, ranks = runs
    for r, out in enumerate(ranks):
        assert out["coords"] == divmod(r, SIZES[1])
        for key in ARCHS:
            assert out["caps"][key] == ref["caps"][key], key
            assert out["expert_range"][key] == (2 * r, 2 * r + 2)
            assert out["serve_expert_range", key] == (2 * r, 2 * r + 2)
            assert len(ref["caps"][key]) == 2 and min(ref["caps"][key]) > 0


def test_dsv2_moe_layers_match_reference(runs):
    """Both MoE layers of DeepSeek-V2-Lite at top-6 with 2 shared experts,
    the kernels wanted and not: output, world-mean metrics (picks dropped
    at this plan's capacities), and the gradients of the input, the gate,
    each rank's routed experts and the shared experts (summed over the
    world)."""
    check_moe_layers(*runs)


def check_moe_layers(ref, ranks):
    """``ref["moe", layer]`` against every rank's ``["moe", layer,
    use_pallas]`` on each of MOE_LAYERS (a DeepSeek-V2 model's)."""
    for use_pallas in (False, True):
        for layer in MOE_LAYERS:
            want = ref["moe", layer]
            got = [out["moe", layer, use_pallas] for out in ranks]
            close(np.concatenate([g["y"] for g in got]), want["y"])
            assert float(want["metrics"]["dropped"]) > 0
            for g in got:
                assert set(g["metrics"]) == set(METRIC_KEYS)
                for k in METRIC_KEYS:
                    close(g["metrics"][k], want["metrics"][k])
            gp, gx = want["grads"]
            close(np.concatenate([g["gx"] for g in got]), gx)
            for g in got:
                close(g["grads"]["gate"], gp["gate"]["w"])
                for k in ("shared_in", "shared_gate", "shared_out"):
                    close(g["grads"][k], gp[k])
            for k in ("w_in", "w_gate", "w_out"):
                close(np.concatenate([g["grads"][k] for g in got]), gp[k])


def test_dsv2_loss_and_every_synced_gradient(runs):
    """``loss_fn`` on the world with a loss mask, the kernels wanted and
    not: the world-mean loss and metrics, and every gradient after
    ``trainer.sync_grads`` (MLA's, the dense layer's, the shared experts'
    and the gate's summed over the world; the routed experts' gathered
    over the EP axes)."""
    ref, ranks = runs
    want = ref["loss"]
    wgrads = _ref_leaves(DSV2, want["grads"])
    for use_pallas in (False, True):
        for out in ranks:
            got = out["loss", use_pallas]
            close(got["metrics"]["loss"], want["loss"])
            for k in want["metrics"]:
                close(got["metrics"][k], want["metrics"][k])
            assert len(got["grads"]) == len(wgrads)
            for g, w in zip(got["grads"], wgrads):
                close(g, w)


@pytest.mark.parametrize("use_pallas", [None, True])
def test_trainers_match_reference(runs, use_pallas):
    """3 ``a2a`` steps of each family on the world: every logged metric on
    every rank, and each rank's final parameters (atol 2e-4)."""
    ref, ranks = runs
    for key in ARCHS:
        want = ref["train", key]
        assert len(want["history"]) == STEPS
        for out in ranks:
            got = out["train", key, use_pallas]
            assert len(got["history"]) == STEPS
            for a, b in zip(got["history"], want["history"]):
                for k in HISTORY_KEYS:
                    close(a[k], b[k])
            final = _ref_leaves(ARCHS[key], want["final"], _world(out))
            assert len(final) == len(got["final"])
            for a, b in zip(got["final"], final):
                close(a, b, rtol=1e-4, atol=2e-4)


def test_dsv2_pipelined_int8_trainer_matches_reference(runs):
    """3 steps through ``a2a_pipelined`` at 2 chunks over the int8 wire,
    the kernel branch (K7's plain version against the reference's
    interpreted kernels): every logged metric within ``TOL`` plus 1e-3 of
    the value, the final parameters within atol 2e-4 but for 0.1%, which
    may sit 2 lr apart (see the module docstring)."""
    from test_torch_pipelined import close_but_flips
    ref, ranks = runs
    want = ref["train_int8"]
    for out in ranks:
        got = out["train_int8"]
        assert got["chunks"] == PIPELINED_CHUNKS
        for a, b in zip(got["history"], want["history"]):
            for k in HISTORY_KEYS:
                w = np.asarray(b[k], dtype=np.float64)
                close_but_flips(a[k], w, level=1e-3 * np.abs(w).max(),
                                frac=1.0)
        final = _ref_leaves(DSV2, want["final"], _world(out))
        for a, b in zip(got["final"], final):
            close_but_flips(a, b, level=2 * LR, frac=1e-3,
                            tol=dict(rtol=1e-4, atol=2e-4))


@pytest.mark.parametrize("key", ARCHS)
def test_gather_serving_tokens_match_reference(runs, key):
    """``ServingEngine.run`` on the world, greedy, every MoE layer through
    ``gather``: MLA's latent cache (DeepSeek-V2-Lite) and Mamba's state
    and the scan prefill (Jamba) in the world's slots; every rank's
    streams are the reference engine's on the (4, 1) mesh, exactly."""
    ref, ranks = runs
    for out in ranks:
        assert out["served", key] == ref["served", key]
    assert sum(len(v) for v in ref["served", key].values()) == sum(BUDGETS)
