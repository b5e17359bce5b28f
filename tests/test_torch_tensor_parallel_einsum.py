"""The einsum baseline with the dense grouped FFN (``MoEConfig.use_kernel``,
K6 on the card) on a tensor-parallel world against the JAX package.

The einsum path is shard-local in both packages: its one-hot ``[T, N,
C]`` buffer holds every expert, so it runs where the EP world is one
rank.  On a mesh whose ``data`` axis spans more than one rank the experts
are split over it and the reference's einsum fails on its own ``[N, C,
d]`` buffer (``ValueError``: the expert label of 4 against a shard of
2), so this parity runs on a (data 1, model 2) world, the card's
``train_tp2`` world: each expert's width and the dense FFN split over
``model``, attention by heads, the embedding by vocabulary.

One JAX subprocess on 2 forced host devices builds reduced
``gpt3_medium_moe`` (4 experts, capacity factor 2) on the ``("data",
"model")`` mesh with ``dispatch="einsum"`` and ``use_moe_kernel`` on and
off, and computes ``loss_fn`` with every gradient, then 3 steps of
``trainer.make_train_step`` on the ``SyntheticLM`` batches from the same
weights.  Beside it 2 CPU processes of the port (``launch.mesh.spawn(...,
model=2)``) run the same, each with its slices: ``expert_ffn`` passes its
input through ``copy_to_model`` and sums its output with
``reduce_from_model``, around ``moe_gemm.ops.grouped_ffn`` (K6's plain
version on the CPU) or the plain tensor products.

Tolerance: rtol = atol = 1e-4 (float32; sums in another order and split
over the model axis); final params atol 2e-4 (``test_torch_training.py``).
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SIZES, MODEL = (1,), 2
SEQ, BATCH, STEPS = 16, 4, 3
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH_ID = "gpt3_medium_moe"
KERNEL = (False, True)

REFERENCE = f"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.compat import make_mesh
from repro.configs.base import RunConfig, get_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import model, transformer
from repro.optim import adamw
from repro.training import trainer

mesh = make_mesh({SIZES + (MODEL,)}, ("data", "model"))
rules = model.default_rules(mesh)
arch = get_config("{ARCH_ID}").reduced()
rng = np.random.default_rng(13)
toks = rng.integers(0, arch.vocab_size, size=({BATCH}, {SEQ} + 1))
batch = {{"tokens": toks[:, :-1].astype(np.int32),
         "labels": toks[:, 1:].astype(np.int32),
         "loss_mask": (rng.random(({BATCH}, {SEQ})) > 0.1).astype(
             np.float32)}}
ctxs = {{k: model.build_ctx(arch, mesh, seq_len={SEQ}, global_batch={BATCH},
                           aux_mode="lb", dispatch="einsum",
                           use_moe_kernel=k) for k in {KERNEL}}}
with mesh, sharding.axis_rules(rules):
    params = model.init_params(jax.random.PRNGKey(0), ctxs[True],
                               rules=rules)
dump_inputs({{"params": jax.tree_util.tree_map(np.asarray, params),
             "batch": batch}})
out = {{}}
jb = {{k: jnp.asarray(v) for k, v in batch.items()}}
for k, ctx in ctxs.items():
    with mesh, sharding.axis_rules(rules):
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p: transformer.loss_fn(p, jb, ctx), has_aux=True))(params)
    out["loss", k] = {{"loss": np.asarray(loss),
                      "metrics": {{kk: np.asarray(v) for kk, v in m.items()}},
                      "grads": jax.tree_util.tree_map(np.asarray, g)}}
run = RunConfig(seq_len={SEQ}, global_batch={BATCH}, warmup_steps=1,
                aux_mode="lb", dispatch="einsum", seed=0)
data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len={SEQ},
                              global_batch={BATCH}, seed=0))
with mesh, sharding.axis_rules(rules):
    step = jax.jit(trainer.make_train_step(ctxs[True], run))
    p, opt = params, adamw.init_state(params)
    hist = []
    for i in range({STEPS}):
        p, opt, m = step(p, opt, {{k: jnp.asarray(v)
                                  for k, v in data.batch(i).items()}})
        hist.append({{k: np.asarray(v) for k, v in m.items()}})
out["history"] = hist
out["final"] = jax.tree_util.tree_map(np.asarray, p)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _rank_main(world, ref_path, out_dir):
    """One process of the (data 1, model 2) world: the loss and its
    synced gradients with the kernel entry wanted and not, then the
    steps; its results go to ``rank<process rank>.pkl``."""
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels.moe_gemm import ops as gemm_ops
    from repro_torch.models import model, transformer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.training import trainer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    arch = get_config(ARCH_ID).reduced()
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    out = {"model_coord": world.model_coord}
    for kernel in KERNEL:
        ctx = model.build_ctx(arch, world, seq_len=SEQ, global_batch=BATCH,
                              aux_mode="lb", dispatch="einsum",
                              use_moe_kernel=kernel, device="cpu")
        params = params_from_numpy(ref["params"], ctx, "cpu")
        for p in adamw.tree_leaves(params):
            p.requires_grad_(True)
        calls = []
        entry = gemm_ops.grouped_ffn
        gemm_ops.grouped_ffn = lambda *a, **kw: (calls.append(1),
                                                 entry(*a, **kw))[1]
        try:
            loss, m = transformer.loss_fn(params, batch, ctx)
        finally:
            gemm_ops.grouped_ffn = entry
        loss.backward()
        out["k6_calls", kernel] = len(calls)
        grads, _ = trainer.sync_grads(params, ctx)
        full = model.gather_params(grads, ctx)
        out["loss", kernel] = {"metrics": world.mean(m),
                               "grads": [t.detach().numpy() for t in
                                         adamw.tree_leaves(full)]}
    run = RunConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                    aux_mode="lb", dispatch="einsum", seed=0)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    params = params_from_numpy(ref["params"], ctx, "cpu")
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    opt = adamw.init_state(params)
    step = trainer.make_train_step(ctx, run)
    hist = []
    for i in range(STEPS):
        params, opt, m = step(params, opt,
                              shard_batch(data.batch(i), world, "cpu"))
        hist.append({k: v.detach().numpy() for k, v in m.items()})
    out["history"] = hist
    out["final"] = [t.detach().numpy() for t in
                    adamw.tree_leaves(model.gather_params(params, ctx))]
    with open(os.path.join(out_dir, f"rank{world.process_rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [process 0, 1 results]) — one JAX subprocess
    and, beside it once it has written the weights and batch, one
    2-process (data 1, model 2) gloo world of the port."""
    from repro_torch.launch import mesh
    from torch_world_reference import run_beside_world
    tmp = tmp_path_factory.mktemp("tensor_parallel_einsum")
    ref = run_beside_world(
        REFERENCE, 2, tmp,
        lambda inputs: mesh.spawn(_rank_main, SIZES, "gloo", "cpu",
                                  args=(inputs, str(tmp)), model=MODEL))
    ranks = []
    for i in range(2):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _ref_leaves(tree):
    """A reference tree (stacked, every expert) in the port's leaf
    order."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), seq_len=SEQ,
                          global_batch=BATCH, device="cpu")
    return [t.numpy() for t in adamw.tree_leaves(
        params_from_numpy(tree, ctx, "cpu"))]


@pytest.mark.parametrize("kernel", KERNEL)
def test_einsum_loss_and_every_gradient_match_reference(runs, kernel):
    """The loss, its metrics and every gradient (synced and gathered over
    the model axis: the experts' halves of every width, the gate whole)
    with ``use_moe_kernel`` off and on; on, the dense grouped FFN entry
    runs once a layer on each model rank."""
    from repro_torch.configs.base import get_config
    ref, ranks = runs
    want = ref["loss", kernel]
    wgrads = _ref_leaves(want["grads"])
    layers = get_config(ARCH_ID).reduced().num_layers
    for out in ranks:
        assert out["k6_calls", kernel] == (layers if kernel else 0)
        got = out["loss", kernel]
        close(got["metrics"]["loss"], want["loss"])
        for k in want["metrics"]:
            close(got["metrics"][k], want["metrics"][k])
        assert len(got["grads"]) == len(wgrads)
        for g, w in zip(got["grads"], wgrads):
            close(g, w)


def test_einsum_kernel_steps_match_reference(runs):
    """3 steps of ``make_train_step`` through the einsum path with the
    kernel entry: every metric of every step, and the final parameters
    gathered over the model axis (atol 2e-4)."""
    ref, ranks = runs
    final = _ref_leaves(ref["final"])
    for out in ranks:
        assert len(out["history"]) == len(ref["history"]) == STEPS
        for got, want in zip(out["history"], ref["history"]):
            for k in want:
                close(got[k], want[k])
        assert len(out["final"]) == len(final)
        for a, b in zip(out["final"], final):
            close(a, b, rtol=1e-4, atol=2e-4)
