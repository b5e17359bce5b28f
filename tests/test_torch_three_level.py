"""The port on the paper's three-level topology (a 2x2x2 pod x node x data
world, the nested ``[[2, 2], [2, 2]]`` spec of Fig. 2) against the JAX
package.

One JAX subprocess on 8 forced host devices (``mesh_from_topology([[2, 2],
[2, 2]])``, as ``tests/test_multidevice.py``'s three-level tests build
it) computes the reference:

- ``a2a`` and ``a2a_pipelined`` at 1, 2 and 3 chunks (the plan aligned to
  the chunk count) through ``_moe_block`` on layer 1 of
  ``gpt3_medium_moe.reduced()`` with 8 experts and capacity factor 8, as
  ``test_three_level_topology_trainer_end_to_end`` configures it: the
  output, the metrics and the gradients of ``sum(y * r) + aux_loss``;
- 3 trainer steps of that model with ``aux_mode="ta"``, ``a2a`` and
  ``a2a_pipelined`` at 2 chunks: the histories;
- data parallelism beside expert parallelism: the reduced model's 4
  experts span ``(node, data)`` and ``pod`` is pure data parallelism;
  2 trainer steps, the histories and the final parameters.  Its capacity
  factor is 8 too, so no pick drops: at the reduced model's 2, 28% of
  the picks drop, and a batch row that starts with the same token twice
  holds two equal hidden states that tie for one slot; which of the two
  is kept then rests on a rounding of the attention weights (one ulp),
  which the two packages take differently.

Beside it, as soon as it has written the weights and batch
(``torch_world_reference``), 8 CPU processes of the port, joined over
gloo (one world, ``launch.mesh.spawn``), run the same from the same
weights, with the
kernels wanted (their plain versions on the CPU) and not.  Every stage of
the three-level plan has more than one destination, so permute -> chain
-> grouped FFN -> reverse chain -> unpermute carries every token; the
outermost stage's chain runs three hops.

Tolerance: rtol = atol = 1e-4 for outputs, metrics, gradients and
histories (float32, the sums run in another order); final params atol
2e-4 (2 AdamW steps at lr 3e-4, see ``test_torch_training.py``); the
expert leaves of the two pod replicas bit-equal.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH_ID = "gpt3_medium_moe"
SPEC = [[2, 2], [2, 2]]
SIZES = (2, 2, 2)
SEQ, BATCH, STEPS, DP_STEPS = 32, 8, 3, 2
TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_KEYS = ("aux_loss", "frac_by_level", "frac_near", "frac_far",
               "dropped")
HISTORY_KEYS = ("loss", "nll", "aux", "frac_by_level", "dropped",
                "grad_norm", "lr")
# (dispatch, chunks) of the engine cases
ENGINES = (("a2a", 1), ("a2a_pipelined", 1), ("a2a_pipelined", 2),
           ("a2a_pipelined", 3))
TRAIN_CHUNKS = 2
# the reference's three-level trainer test: 8 experts, capacity factor 8;
# the data-parallel case keeps the reduced model's 4 experts
ARCH8 = ("dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, "
         "num_experts=8, top_k=2, capacity_factor=8.0))")
ARCH4 = ("dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, "
         "capacity_factor=8.0))")

REFERENCE = f"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.configs.base import RunConfig, get_config
from repro.launch.mesh import mesh_from_topology
from repro.models import model, transformer
from repro.training import trainer

mesh = mesh_from_topology({SPEC})
arch = get_config("{ARCH_ID}").reduced()
arch8, arch4 = {ARCH8}, {ARCH4}
rules = model.default_rules(mesh)
rng = np.random.default_rng(5)
x = rng.standard_normal(({BATCH}, {SEQ}, arch.d_model)).astype(np.float32)
r = rng.standard_normal(x.shape).astype(np.float32)
out = {{"x": x, "r": r, "engines": {{}}, "plans": {{}}}}


def ctx_for(a, dispatch="a2a", chunks=0):
    return model.build_ctx(a, mesh, seq_len={SEQ}, global_batch={BATCH},
                           aux_mode="ta", dispatch=dispatch,
                           a2a_num_chunks=chunks)


ctx = ctx_for(arch8)
dctx = ctx_for(arch4)
with mesh, sharding.axis_rules(rules):
    params = model.init_params(jax.random.PRNGKey(0), ctx, rules=rules)
    dparams = model.init_params(jax.random.PRNGKey(0), dctx, rules=rules)
out["params"] = jax.tree_util.tree_map(np.asarray, params)
out["dp_params"] = jax.tree_util.tree_map(np.asarray, dparams)
dump_inputs({{k: out[k] for k in ("params", "dp_params", "x", "r")}})
p1 = jax.tree_util.tree_map(lambda a: a[1], params["groups"])["sub0"]["ffn"]
for name, k in {ENGINES}:
    c = ctx_for(arch8, name, k)

    def loss(p, xx, c=c):
        y, m = transformer._moe_block(p, xx, c, decode=False, layer_idx=1)
        return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)

    with mesh:
        (_, (y, m)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p1, jnp.asarray(x))
    out["engines"][name, k] = {{
        "y": np.asarray(y),
        "metrics": {{kk: np.asarray(v) for kk, v in m.items()}},
        "grads": jax.tree_util.tree_map(np.asarray, g)}}
    out["plans"][name, k] = (c.plan.caps, c.plan.level_axes,
                             c.a2a_num_chunks)

base = dict(seq_len={SEQ}, global_batch={BATCH}, warmup_steps=1,
            aux_mode="ta", seed=0)
out["history"] = trainer.train(
    arch8, RunConfig(dispatch="a2a", **base), mesh, steps={STEPS},
    log_every=1, verbose=False).metrics_history
out["pipelined_history"] = trainer.train(
    arch8, RunConfig(dispatch="a2a_pipelined",
                     a2a_num_chunks={TRAIN_CHUNKS}, **base), mesh,
    steps={STEPS}, log_every=1, verbose=False).metrics_history

p1 = jax.tree_util.tree_map(lambda a: a[1], dparams["groups"])["sub0"]["ffn"]


def gloss(p, xx):
    y, m = transformer._moe_block(p, xx, dctx, decode=True, layer_idx=1)
    return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)


with mesh:
    (_, (y, m)), g = jax.jit(jax.value_and_grad(
        gloss, argnums=(0, 1), has_aux=True))(p1, jnp.asarray(x))
out["dp_gather"] = {{"y": np.asarray(y),
                    "metrics": {{k: np.asarray(v) for k, v in m.items()}},
                    "grads": jax.tree_util.tree_map(np.asarray, g)}}
out["dp_ep_axes"] = dctx.ep.axis_names
out["dp_caps"] = dctx.plan.caps
res = trainer.train(arch4, RunConfig(dispatch="a2a", **base), mesh,
                    steps={DP_STEPS}, log_every=1, verbose=False)
out["dp_history"] = res.metrics_history
out["dp_final"] = jax.tree_util.tree_map(np.asarray, res.params)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _archs():
    """The port's (8-expert, data-parallel) architectures: ARCH8's and
    ARCH4's text, which builds the reference's too."""
    import dataclasses  # noqa: F401 (the texts name it)
    from repro_torch.configs.base import get_config
    arch = get_config(ARCH_ID).reduced()
    return eval(ARCH8), eval(ARCH4)


def _rank_main(world, ref_path, out_dir):
    """One rank of the 2x2x2 world: the engine cases and the trainers,
    with the kernels wanted and not; its results go to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    arch8, arch4 = _archs()
    per = BATCH // world.size
    rows = slice(world.rank * per, (world.rank + 1) * per)
    out = {"rank": world.rank, "coords": world.coords, "engines": {}}

    def ctx_for(arch, dispatch="a2a", chunks=0, use_pallas=None):
        return model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                               aux_mode="ta", dispatch=dispatch,
                               a2a_num_chunks=chunks, use_pallas=use_pallas,
                               device="cpu")

    for use_pallas in (False, True):
        for name, k in ENGINES:
            ctx = ctx_for(arch8, name, k, use_pallas)
            params = params_from_numpy(ref["params"], ctx, "cpu")
            p = {kk: (v.requires_grad_(True) if torch.is_tensor(v)
                      else {n: t.requires_grad_(True) for n, t in v.items()})
                 for kk, v in params["layers"][1]["ffn"].items()}
            x = torch.from_numpy(ref["x"][rows].copy()).requires_grad_(True)
            y, m = transformer._moe_block(p, x, ctx, decode=False,
                                          layer_idx=1)
            (torch.sum(y * torch.from_numpy(ref["r"][rows].copy()))
             + m["aux_loss"] / world.size).backward()
            out["engines"][use_pallas, name, k] = {
                "plan": (ctx.plan.caps, ctx.plan.level_axes,
                         ctx.a2a_num_chunks),
                "expert_range": ctx.expert_range,
                "y": y.detach().numpy(),
                "metrics": {n: v.detach().numpy() for n, v in m.items()},
                "gx": x.grad.numpy(),
                "g_gate": world.all_reduce_sum(p["gate"]["w"].grad).numpy(),
                "g_w_in": p["w_in"].grad.numpy(),
                "g_w_out": p["w_out"].grad.numpy()}

    # the gather path where the EP axes are a subset of the world's: one
    # all-gather and one all-reduce over the (node, data) group of each pod
    for use_pallas in (False, True):
        ctx = ctx_for(arch4, use_pallas=use_pallas)
        params = params_from_numpy(ref["dp_params"], ctx, "cpu")
        p = {kk: (v.requires_grad_(True) if torch.is_tensor(v)
                  else {n: t.requires_grad_(True) for n, t in v.items()})
             for kk, v in params["layers"][1]["ffn"].items()}
        x = torch.from_numpy(ref["x"][rows].copy()).requires_grad_(True)
        y, m = transformer._moe_block(p, x, ctx, decode=True, layer_idx=1)
        (torch.sum(y * torch.from_numpy(ref["r"][rows].copy()))
         + m["aux_loss"] / world.size).backward()
        out["dp_gather", use_pallas] = {
            "y": y.detach().numpy(),
            "metrics": {n: v.detach().numpy() for n, v in m.items()},
            "gx": x.grad.numpy(),
            "g_gate": world.all_reduce_sum(p["gate"]["w"].grad).numpy(),
            "g_w_in": world.all_reduce_sum(p["w_in"].grad,
                                           ("pod",)).numpy(),
            "g_w_out": world.all_reduce_sum(p["w_out"].grad,
                                            ("pod",)).numpy()}

    def train(arch, tree, steps, **kw):
        run = RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                        aux_mode="ta", seed=0, **kw)
        ctx = ctx_for(arch, run.dispatch, run.a2a_num_chunks)
        res = trainer.train(arch, run, world, steps=steps, log_every=1,
                            verbose=False,
                            params=params_from_numpy(tree, ctx, "cpu"),
                            device="cpu")
        return res, ctx

    for use_pallas in (None, True):
        res, _ = train(arch8, ref["params"], STEPS, dispatch="a2a",
                       use_pallas=use_pallas)
        out["history", use_pallas] = res.metrics_history
        res, ctx = train(arch4, ref["dp_params"], DP_STEPS, dispatch="a2a",
                         use_pallas=use_pallas)
        out["dp", use_pallas] = {
            "history": res.metrics_history, "ep_axes": ctx.ep.axis_names,
            "caps": ctx.plan.caps, "expert_range": ctx.expert_range,
            "final": [t.detach().numpy() for t in
                      adamw.tree_leaves(res.params)],
            "expert_mask": trainer.expert_mask(res.params, ctx)}
    res, _ = train(arch8, ref["params"], STEPS, dispatch="a2a_pipelined",
                   a2a_num_chunks=TRAIN_CHUNKS, use_pallas=True)
    out["pipelined_history"] = res.metrics_history
    with open(os.path.join(out_dir, f"rank{world.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0..7 results]) — one JAX subprocess on 8
    forced host devices and, beside it once it has made both models'
    weights and the batch, one 8-process gloo world of the port."""
    from repro_torch.launch import mesh
    from torch_world_reference import run_beside_world
    tmp = tmp_path_factory.mktemp("world222")
    sizes = mesh.mesh_from_topology(SPEC)
    assert sizes == SIZES
    ref = run_beside_world(
        REFERENCE, 8, tmp,
        lambda inputs: mesh.spawn(_rank_main, sizes, "gloo", "cpu",
                                  args=(inputs, str(tmp))))
    ranks = []
    for i in range(8):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_world_layout_and_three_level_plan(runs):
    """Rank r sits at row-major (pod, node, data) coordinates and holds
    expert r; the plan has three stages over the reference's level axes,
    caps[0] > caps[1] > caps[2] > 0, the reference's capacities (aligned
    to each chunk count)."""
    ref, ranks = runs
    for r, out in enumerate(ranks):
        assert out["rank"] == r
        assert out["coords"] == (r // 4, r // 2 % 2, r % 2)
        for use_pallas in (False, True):
            for name, k in ENGINES:
                got = out["engines"][use_pallas, name, k]
                assert got["plan"] == ref["plans"][name, k]
                assert got["expert_range"] == (r, r + 1)
    caps, axes, _ = ref["plans"]["a2a", 1]
    assert axes == (("data",), ("node", "data"), ("pod", "node", "data"))
    assert caps[0] > caps[1] > caps[2] > 0


@pytest.mark.parametrize("name,chunks", ENGINES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_engines_match_reference(runs, use_pallas, name, chunks):
    """Output, world-mean metrics (a length-3 frac_by_level with every
    level used) and gradients against the reference."""
    ref, ranks = runs
    want = ref["engines"][name, chunks]
    got = [out["engines"][use_pallas, name, chunks] for out in ranks]
    close(np.concatenate([g["y"] for g in got]), want["y"])
    fb = np.asarray(want["metrics"]["frac_by_level"])
    assert fb.shape == (3,) and (fb > 0).all()
    for g in got:
        assert set(g["metrics"]) == set(METRIC_KEYS)
        for k in METRIC_KEYS:
            close(g["metrics"][k], want["metrics"][k])
    grads = want["grads"]
    close(np.concatenate([g["gx"] for g in got]), grads[1])
    for g in got:
        close(g["g_gate"], grads[0]["gate"]["w"])
    for k in ("w_in", "w_out"):
        close(np.concatenate([g[f"g_{k}"] for g in got]), grads[0][k])


@pytest.mark.parametrize("use_pallas", [None, True])
def test_trainer_matches_reference(runs, use_pallas):
    """3 steps of ``a2a`` training on the three-level world: every logged
    metric, the length-3 frac_by_level and the global grad norm included,
    on every rank."""
    ref, ranks = runs
    assert len(ref["history"]) == STEPS
    for out in ranks:
        hist = out["history", use_pallas]
        assert len(hist) == STEPS
        for got, want in zip(hist, ref["history"]):
            assert len(got["frac_by_level"]) == 3
            for k in HISTORY_KEYS:
                close(got[k], want[k])


def test_pipelined_trainer_matches_reference(runs):
    """The same through ``a2a_pipelined`` at 2 chunks, kernels wanted."""
    ref, ranks = runs
    for out in ranks:
        for got, want in zip(out["pipelined_history"],
                             ref["pipelined_history"]):
            for k in HISTORY_KEYS:
                close(got[k], want[k])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gather_engine_over_a_subset_of_axes(runs, use_pallas):
    """The gather path on the data-parallel world: the EP axes (node,
    data) are a subset of the world's, so each pod gathers its own four
    ranks' tokens and sums its own partial outputs.  Output, metrics and
    gradients against the reference (expert gradients summed over the
    pod replicas, as the trainer sums them)."""
    ref, ranks = runs
    want = ref["dp_gather"]
    got = [out["dp_gather", use_pallas] for out in ranks]
    close(np.concatenate([g["y"] for g in got]), want["y"])
    for g in got:
        for k in METRIC_KEYS:
            close(g["metrics"][k], want["metrics"][k])
        close(g["g_gate"], want["grads"][0]["gate"]["w"])
    close(np.concatenate([g["gx"] for g in got]), want["grads"][1])
    for k in ("w_in", "w_out"):
        close(np.concatenate([g[f"g_{k}"] for g in got[:4]]),
              want["grads"][0][k])


@pytest.mark.parametrize("use_pallas", [None, True])
def test_data_parallel_trainer_matches_reference(runs, use_pallas):
    """4 experts on the 8-rank world: EP spans (node, data), pod is data
    parallelism.  2 steps against the reference's losses, grad norms and
    every logged metric, and the final parameters (atol 2e-4); rank r
    holds expert r % 4."""
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    ref, ranks = runs
    assert tuple(ref["dp_ep_axes"]) == ("node", "data")
    _, arch = _archs()
    for r, out in enumerate(ranks):
        dp = out["dp", use_pallas]
        assert dp["ep_axes"] == ("node", "data")
        assert dp["caps"] == ref["dp_caps"]
        assert dp["expert_range"] == (r % 4, r % 4 + 1)
        assert len(dp["history"]) == DP_STEPS
        for got, want in zip(dp["history"], ref["dp_history"]):
            for k in HISTORY_KEYS:
                close(got[k], want[k])
        world = EPWorld(axis_names=("pod", "node", "data"),
                        axis_sizes=SIZES, coords=out["coords"])
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              device="cpu")
        want = adamw.tree_leaves(params_from_numpy(ref["dp_final"], ctx,
                                                   "cpu"))
        assert len(want) == len(dp["final"])
        for a, b in zip(dp["final"], want):
            close(a, b, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("use_pallas", [None, True])
def test_data_parallel_replicas_hold_bit_equal_experts(runs, use_pallas):
    """After the steps, each expert leaf on pod 0 is bit-equal to its
    replica on pod 1 (rank r + 4): the data-parallel sum of the expert
    gradients reached both, and AdamW did the same with it."""
    _, ranks = runs
    for r in range(4):
        a, b = ranks[r]["dp", use_pallas], ranks[r + 4]["dp", use_pallas]
        assert any(a["expert_mask"])
        for ta, tb, is_expert in zip(a["final"], b["final"],
                                     a["expert_mask"]):
            if is_expert:
                np.testing.assert_array_equal(ta, tb)
