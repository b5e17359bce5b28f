"""The port on a 2x2 (pod x data) EP world against the JAX package.

One JAX subprocess on 4 forced host devices (mesh ``(2, 2, 1)`` over
``("pod", "data", "model")``, as ``tests/test_multidevice.py`` runs it)
computes the reference: the ``a2a`` engine through ``_moe_block`` on
layer 1 of ``gpt3_medium_moe.reduced()`` (float32) with the gradients of
``sum(y * r) + aux_loss``, and 2 trainer steps with ``aux_mode="ta"``.
Then 4 CPU processes of the port, joined by ``torch.distributed`` over
gloo (``launch.mesh.spawn``), run the same from the same weights, each on
its batch shard with its expert shard; the EP plan has two remote stages,
so permute -> all-to-all chain -> ragged grouped FFN -> reverse chain ->
unpermute carries every token, kernels wanted (their plain versions on
the CPU) and not.

Tolerance: rtol = atol = 1e-4 for outputs, metrics and gradients (float32,
the sums run in another order); final params atol 2e-4 (2 AdamW steps at
lr 3e-4, see ``test_torch_training.py``).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_ID = "gpt3_medium_moe"
SEQ, BATCH, STEPS = 32, 8, 2
SIZES = (2, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_KEYS = ("aux_loss", "frac_by_level", "frac_near", "frac_far",
               "dropped")
HISTORY_KEYS = ("loss", "nll", "aux", "frac_by_level", "dropped",
                "grad_norm", "lr")

REFERENCE = f"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import RunConfig, get_config
from repro.models import model, transformer
from repro.training import trainer

mesh = make_mesh({SIZES + (1,)}, ("pod", "data", "model"))
arch = get_config("{ARCH_ID}").reduced()
ctx = model.build_ctx(arch, mesh, seq_len={SEQ}, global_batch={BATCH},
                      aux_mode="ta")
rules = model.default_rules(mesh)
with mesh, sharding.axis_rules(rules):
    params = model.init_params(jax.random.PRNGKey(0), ctx, rules=rules)
tree = jax.tree_util.tree_map(np.asarray, params)
rng = np.random.default_rng(5)
x = rng.standard_normal(({BATCH}, {SEQ}, arch.d_model)).astype(np.float32)
r = rng.standard_normal(x.shape).astype(np.float32)
p1 = jax.tree_util.tree_map(lambda a: a[1], params["groups"])["sub0"]["ffn"]

def loss(p, xx):
    y, m = transformer._moe_block(p, xx, ctx, decode=False, layer_idx=1)
    return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)

with mesh:
    (_, (y, m)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p1, jnp.asarray(x))
run = RunConfig(seq_len={SEQ}, global_batch={BATCH}, warmup_steps=1,
                aux_mode="ta", dispatch="a2a", seed=0)
res = trainer.train(arch, run, mesh, steps={STEPS}, log_every=1,
                    verbose=False)
with open(sys.argv[1], "wb") as f:
    pickle.dump({{"params": tree, "caps": ctx.plan.caps, "x": x, "r": r,
                 "y": np.asarray(y),
                 "metrics": {{k: np.asarray(v) for k, v in m.items()}},
                 "grads": jax.tree_util.tree_map(np.asarray, g),
                 "history": res.metrics_history,
                 "final": jax.tree_util.tree_map(np.asarray, res.params)}}, f)
"""


def _rank_main(world, ref_path, out_dir):
    """One rank of the port's world: the engine case and the trainer, with
    the kernels wanted and not; its results go to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    arch = get_config(ARCH_ID).reduced()
    per = BATCH // world.size
    rows = slice(world.rank * per, (world.rank + 1) * per)
    out = {"rank": world.rank, "coords": world.coords}
    for use_pallas in (False, True):
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              aux_mode="ta", use_pallas=use_pallas,
                              device="cpu")
        params = params_from_numpy(ref["params"], ctx, "cpu")
        p = {k: (v.requires_grad_(True) if torch.is_tensor(v)
                 else {kk: vv.requires_grad_(True) for kk, vv in v.items()})
             for k, v in params["layers"][1]["ffn"].items()}
        x = torch.from_numpy(ref["x"][rows].copy()).requires_grad_(True)
        y, m = transformer._moe_block(p, x, ctx, decode=False, layer_idx=1)
        # this rank's part of the global sum(y * r) + pmean(aux): the aux
        # loss keeps this rank's own gradient (see transformer._world_mean)
        (torch.sum(y * torch.from_numpy(ref["r"][rows].copy()))
         + m["aux_loss"] / world.size).backward()
        gate = world.all_reduce_sum(p["gate"]["w"].grad)
        res = trainer.train(
            arch, RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                            aux_mode="ta", dispatch="a2a", seed=0,
                            use_pallas=use_pallas),
            world, steps=STEPS, log_every=1, verbose=False,
            params=params_from_numpy(ref["params"], ctx, "cpu"),
            device="cpu")
        out[use_pallas] = {
            "caps": ctx.plan.caps, "expert_range": ctx.expert_range,
            "y": y.detach().numpy(),
            "metrics": {k: v.detach().numpy() for k, v in m.items()},
            "gx": x.grad.numpy(), "g_gate": gate.numpy(),
            "g_w_in": p["w_in"].grad.numpy(),
            "g_w_out": p["w_out"].grad.numpy(),
            "history": res.metrics_history,
            "final": [t.detach().numpy() for t in
                      _leaves(res.params)]}
    with open(os.path.join(out_dir, f"rank{world.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _leaves(tree):
    from repro_torch.optim import adamw
    return adamw.tree_leaves(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0..3 results]) — one JAX subprocess, then
    one 4-process gloo world of the port."""
    from repro_torch.launch import mesh
    tmp = tmp_path_factory.mktemp("world22")
    ref_path = str(tmp / "reference.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        ref_path], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-4000:]}"
    mesh.spawn(_rank_main, SIZES, "gloo", "cpu", args=(ref_path, str(tmp)))
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for i in range(4):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_world_layout_and_plan(runs):
    """Rank r sits at row-major (pod, data) coordinates, holds experts
    r*E_l:(r+1)*E_l, and plans the reference's capacities."""
    ref, ranks = runs
    for r, out in enumerate(ranks):
        assert out["rank"] == r
        assert out["coords"] == divmod(r, SIZES[1])
        for use_pallas in (False, True):
            assert out[use_pallas]["caps"] == ref["caps"]
            assert out[use_pallas]["expert_range"] == (r, r + 1)
    assert len(ref["caps"]) == 2 and min(ref["caps"]) > 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_a2a_engine_outputs_and_metrics_match_reference(runs, use_pallas):
    ref, ranks = runs
    y = np.concatenate([out[use_pallas]["y"] for out in ranks])
    close(y, ref["y"])
    for out in ranks:                     # world means: equal on every rank
        assert set(out[use_pallas]["metrics"]) == set(METRIC_KEYS)
        for k in METRIC_KEYS:
            close(out[use_pallas]["metrics"][k], ref["metrics"][k])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_a2a_engine_grads_match_reference(runs, use_pallas):
    ref, ranks = runs
    g = ref["grads"]
    close(np.concatenate([out[use_pallas]["gx"] for out in ranks]), g[1])
    for out in ranks:
        close(out[use_pallas]["g_gate"], g[0]["gate"]["w"])
    for k in ("w_in", "w_out"):
        close(np.concatenate([out[use_pallas][f"g_{k}"] for out in ranks]),
              g[0][k])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainer_steps_match_reference(runs, use_pallas):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.launch.mesh import EPWorld
    ref, ranks = runs
    for out in ranks:
        hist = out[use_pallas]["history"]
        assert len(hist) == len(ref["history"]) == STEPS
        for got, want in zip(hist, ref["history"]):
            for k in HISTORY_KEYS:
                close(got[k], want[k])
    arch = get_config(ARCH_ID).reduced()
    for out in ranks:
        world = EPWorld(axis_names=("pod", "data"), axis_sizes=SIZES,
                        coords=out["coords"])
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              device="cpu")
        want = _leaves(params_from_numpy(ref["final"], ctx, "cpu"))
        assert len(want) == len(out[use_pallas]["final"])
        for a, b in zip(out[use_pallas]["final"], want):
            close(a, b, rtol=1e-4, atol=2e-4)
