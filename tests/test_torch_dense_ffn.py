"""The dense grouped FFN (K6's entries) and the einsum dispatch with
``use_moe_kernel=True``, port against the JAX package on the CPU.

- ``moe_gemm.ops.grouped_ffn`` against ``grouped_ffn_pallas(...,
  interpret=True)`` and ``grouped_ffn_ref`` over ``tests/test_kernels.py``'s
  swiglu sweep and gelu case, and over the shapes at the edges of K6's
  64-row tiles (C = 1, 64, 65, 200; E = 1) in both activations, rows that
  are zero coming out as exact zeros; ``ops._dense_cuda`` refusing bad
  inputs before it builds anything; and its gradients (the ``autograd.Function``
  driven on the CPU with the plain forward) against the reference's
  ``custom_vjp``; ``grouped_ffn`` on an unpadded capacity axis against
  the JAX ``grouped_ffn_chunk`` at row alignments that pad and that do
  not (the port has no chunk entry: its kernel masks the last tile).
- ``expert_ffn`` / ``expert_ffn_flat`` with ``MoEConfig(use_kernel=True)``
  against the JAX package's, kernels wanted and off.
- The ``einsum`` path through ``_moe_block`` of ``gpt3_medium_moe.reduced()``
  with ``use_moe_kernel=True``: output, every metric and the gradients of
  every MoE parameter and the input; then one ``make_train_step`` with
  ``aux_mode="lb"``: metrics and every parameter.

The CUDA kernel runs only on the card (``chip_smoke.py``).  Inputs are made
by numpy from a seed; tolerance rtol = atol = 1e-4 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sharding
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_config as jax_get_config
from repro.core.dispatch import base as jbase
from repro.data import pipeline as jpipeline
from repro.kernels.moe_gemm import ops as jgemm_ops
from repro.kernels.moe_gemm.kernel import grouped_ffn_pallas
from repro.kernels.moe_gemm.ref import grouped_ffn_ref as jgrouped_ffn_ref
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer
from repro_torch.configs.base import RunConfig, get_config
from repro_torch.core.dispatch import base, transport
from repro_torch.data import pipeline
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.models import model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.training import trainer

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH_ID = "gpt3_medium_moe"
SEQ, BATCH = 32, 4


def close(got, want):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def t(a):
    return torch.from_numpy(np.array(a))


def ffn_inputs(seed, E, C, d, f, gate=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    wi, wg = ((rng.standard_normal((E, d, f)) * 0.1).astype(np.float32)
              for _ in range(2))
    wo = (rng.standard_normal((E, f, d)) * 0.1).astype(np.float32)
    return x, wi, wg if gate else None, wo


#: shapes at the edges of K6's 64-row tiles (E, C, d, f, block_c, block_f
#: of the JAX kernel): one row, one whole tile, one row past it, a last
#: tile of 8 rows, one expert
K6_EDGES = [
    (3, 1, 64, 128, 8, 64),
    (2, 64, 64, 128, 64, 64),
    (2, 65, 64, 128, 64, 64),
    (2, 200, 64, 128, 64, 64),
    (1, 40, 128, 64, 16, 64),
]


@pytest.mark.parametrize("E,C,d,f,bc,bf", [
    (1, 8, 32, 64, 8, 32),
    (3, 40, 64, 96, 16, 32),
    (4, 128, 128, 256, 64, 128),
    (2, 16, 48, 80, 16, 80),
] + K6_EDGES)
def test_grouped_ffn_matches_pallas_and_ref_swiglu(E, C, d, f, bc, bf):
    x, wi, wg, wo = ffn_inputs(E * C, E, C, d, f)
    got = gemm_ops.grouped_ffn(t(x), t(wi), t(wg), t(wo))
    assert got.dtype == torch.float32 and got.shape == (E, C, d)
    close(got, grouped_ffn_pallas(x, wi, wg, wo, block_c=bc, block_f=bf,
                                  interpret=True))
    close(got, jgrouped_ffn_ref(x, wi, wg, wo))


def test_grouped_ffn_matches_pallas_and_ref_gelu():
    x, wi, _, wo = ffn_inputs(7, 2, 24, 32, 64, gate=False)
    got = gemm_ops.grouped_ffn(t(x), t(wi), None, t(wo), activation="gelu")
    close(got, grouped_ffn_pallas(x, wi, None, wo, activation="gelu",
                                  block_c=8, block_f=32, interpret=True))
    close(got, jgrouped_ffn_ref(x, wi, None, wo, activation="gelu"))
    # swiglu asked for without a gate projection runs gelu, as in JAX
    close(gemm_ops.grouped_ffn(t(x), t(wi), None, t(wo)), got)


@pytest.mark.parametrize("E,C,d,f,bc,bf", K6_EDGES)
def test_grouped_ffn_matches_pallas_and_ref_gelu_edges(E, C, d, f, bc, bf):
    x, wi, _, wo = ffn_inputs(E + C, E, C, d, f, gate=False)
    x[:, C // 2:] = 0                  # rows past a count, as dispatched
    got = gemm_ops.grouped_ffn(t(x), t(wi), None, t(wo), activation="gelu")
    assert got.shape == (E, C, d)
    close(got, grouped_ffn_pallas(x, wi, None, wo, activation="gelu",
                                  block_c=bc, block_f=bf, interpret=True))
    close(got, jgrouped_ffn_ref(x, wi, None, wo, activation="gelu"))
    assert bool((got[:, C // 2:] == 0).all())


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", [
    "d_not_64", "f_not_64", "w_in_shape", "w_out_shape", "w_gate_shape",
    "x_float32", "w_out_float32"])
def test_dense_cuda_refuses_bad_inputs_before_building(monkeypatch, case):
    def built():
        raise AssertionError("the kernel was built for a bad input")

    monkeypatch.setattr(gemm_ops, "_dense_entry", built)
    E, C, d, f = 2, 8, 64, 128
    args = {"x": _bf16(E, C, d), "w_in": _bf16(E, d, f), "w_gate": None,
            "w_out": _bf16(E, f, d)}
    act = "gelu"
    if case == "d_not_64":
        args.update(x=_bf16(E, C, 32), w_in=_bf16(E, 32, f),
                    w_out=_bf16(E, f, 32))
    elif case == "f_not_64":
        args.update(w_in=_bf16(E, d, 96), w_out=_bf16(E, 96, d))
    elif case == "w_in_shape":
        args.update(w_in=_bf16(E + 1, d, f))
    elif case == "w_out_shape":
        args.update(w_out=_bf16(E, d, f))
    elif case == "w_gate_shape":
        act = "swiglu"
        args.update(w_gate=_bf16(E, d, f + 64))
    elif case == "x_float32":
        args.update(x=torch.zeros((E, C, d)))
    elif case == "w_out_float32":
        args.update(w_out=torch.zeros((E, f, d)))
    with pytest.raises((TypeError, ValueError)):
        gemm_ops._dense_cuda(act, args["x"], args["w_in"], args["w_gate"],
                             args["w_out"])


def test_dense_cuda_builds_for_good_inputs(monkeypatch):
    """The control for the refusals above: good inputs pass every check
    and reach the build."""
    class Built(Exception):
        pass

    def built():
        raise Built

    monkeypatch.setattr(gemm_ops, "_dense_entry", built)
    E, C, d, f = 2, 8, 64, 128
    with pytest.raises(Built):
        gemm_ops._dense_cuda("swiglu", _bf16(E, C, d), _bf16(E, d, f),
                             _bf16(E, d, f), _bf16(E, f, d))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_grouped_ffn_grads_match_custom_vjp(activation):
    x, wi, wg, wo = ffn_inputs(11, 2, 16, 32, 48,
                               gate=activation == "swiglu")

    def jloss(x_, wi_, wg_, wo_):
        y = grouped_ffn_pallas(x_, wi_, wg_, wo_, activation=activation,
                               interpret=True)
        return jnp.sum(y ** 2)

    argnums = (0, 1, 2, 3) if wg is not None else (0, 1, 3)
    want = jax.grad(jloss, argnums)(x, wi, wg, wo)
    leaves = [t(a).requires_grad_(True) if a is not None else None
              for a in (x, wi, wg, wo)]
    y = gemm_ops.grouped_ffn(*leaves, activation=activation)
    torch.sum(y ** 2).backward()
    got = [leaves[i].grad for i in argnums]
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("C,row_align", [(40, 16), (40, 128), (32, 16)])
def test_grouped_ffn_matches_jax_chunk_entry(C, row_align):
    x, wi, wg, wo = ffn_inputs(C + row_align, 3, C, 32, 64)
    got = gemm_ops.grouped_ffn(t(x), t(wi), t(wg), t(wo))
    assert got.shape == (3, C, 32)
    close(got, jgemm_ops.grouped_ffn_chunk(x, wi, wg, wo,
                                           row_align=row_align))
    close(got, jgrouped_ffn_ref(x, wi, wg, wo))


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_expert_ffn_use_kernel_matches_jax(activation, use_pallas):
    E, C, d, f = 3, 8, 32, 64
    x, wi, wg, wo = ffn_inputs(3, E, C, d, f, gate=activation == "swiglu")
    kw = dict(d_model=d, d_ff=f, num_experts=E, top_k=2,
              activation=activation, use_kernel=True)
    jcfg = jbase.MoEConfig(dtype=jnp.float32, **kw)
    cfg = base.MoEConfig(dtype=torch.float32, **kw)
    assert cfg.use_kernel
    jep = jbase.EPSpec.from_axes(("data",), (1,))
    ep = base.EPSpec.from_axes(("data",), (1,))
    jp = {"w_in": wi, "w_out": wo}
    if wg is not None:
        jp["w_gate"] = wg
    p = {k: t(v) for k, v in jp.items()}
    close(base.expert_ffn(p, t(x), cfg, ep), jbase.expert_ffn(jp, x, jcfg,
                                                              jep))
    offs = transport.expert_segments(E, C)
    want = jbase.expert_ffn_flat(jp, x.reshape(E * C, d), offs, jcfg, jep,
                                 use_pallas=use_pallas)
    got = base.expert_ffn_flat(p, t(x).reshape(E * C, d), offs, cfg, ep,
                               use_pallas=use_pallas)
    close(got, want)


# ---------------------------------------------------------------------------
# the einsum path with use_moe_kernel=True
# ---------------------------------------------------------------------------


def einsum_ctxs(mesh11):
    kw = dict(seq_len=SEQ, global_batch=BATCH, aux_mode="lb",
              dispatch="einsum", use_moe_kernel=True)
    jctx = jmodel.build_ctx(jax_get_config(ARCH_ID).reduced(), mesh11, **kw)
    ctx = model.build_ctx(get_config(ARCH_ID).reduced(), device="cpu", **kw)
    assert ctx.use_moe_kernel and ctx.moe_cfg.use_kernel
    assert jctx.moe_cfg.use_kernel
    return jctx, ctx


@pytest.fixture(scope="module")
def einsum_weights(mesh11):
    jctx, ctx = einsum_ctxs(mesh11)
    with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
        jparams = jmodel.init_params(jax.random.PRNGKey(0), jctx,
                                     rules=jmodel.default_rules(mesh11))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, tree


def test_einsum_moe_block_with_kernel_matches_reference(mesh11,
                                                        einsum_weights):
    jparams, tree = einsum_weights
    jctx, ctx = einsum_ctxs(mesh11)
    params = params_from_numpy(tree, ctx, "cpu")
    rng = np.random.default_rng(5)
    d = ctx.arch.d_model
    x = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    r = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["groups"])["sub0"]

    def jloss(p, xx):
        y, m = jtransformer._moe_block(p, xx, jctx, decode=False,
                                       layer_idx=1)
        return jnp.sum(y * jnp.asarray(r)) + m["aux_loss"], (y, m)
    (_, (jy, jm)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp["ffn"], jnp.asarray(x))

    p = {k: (v.detach().clone().requires_grad_(True) if torch.is_tensor(v)
             else {kk: vv.detach().clone().requires_grad_(True)
                   for kk, vv in v.items()})
         for k, v in params["layers"][1]["ffn"].items()}
    xt = t(x).requires_grad_(True)
    y, m = transformer._moe_block(p, xt, ctx, decode=False, layer_idx=1)
    (torch.sum(y * t(r)) + m["aux_loss"]).backward()
    close(y, jy)
    assert set(m) == set(jm)
    for k in m:
        close(m[k], jm[k])
    close(xt.grad, jg[1])
    close(p["gate"]["w"].grad, jg[0]["gate"]["w"])
    for k in ("w_in", "w_out"):
        close(p[k].grad, jg[0][k])


def test_einsum_train_step_with_kernel_matches_reference(mesh11,
                                                         einsum_weights):
    jparams, tree = einsum_weights
    jctx, ctx = einsum_ctxs(mesh11)
    run_kw = dict(seq_len=SEQ, global_batch=BATCH, warmup_steps=1,
                  aux_mode="lb", dispatch="einsum", seed=0)
    data_cfg = dict(vocab_size=ctx.arch.vocab_size, seq_len=SEQ,
                    global_batch=BATCH, seed=0)
    host = jpipeline.SyntheticLM(jpipeline.DataConfig(**data_cfg)).batch(0)
    with mesh11, sharding.axis_rules(jmodel.default_rules(mesh11)):
        jstep = jax.jit(jtrainer.make_train_step(jctx, JRunConfig(**run_kw)))
        jnew, _, jm = jstep(jparams, jadamw.init_state(jparams),
                            jpipeline.shard_batch(host, mesh11))
    params = params_from_numpy(tree, ctx, "cpu")
    for leaf in adamw.tree_leaves(params):
        leaf.requires_grad_(True)
    step = trainer.make_train_step(ctx, RunConfig(**run_kw))
    batch = pipeline.shard_batch(
        pipeline.SyntheticLM(pipeline.DataConfig(**data_cfg)).batch(0),
        None, "cpu")
    new, _, m = step(params, adamw.init_state(params), batch)
    for k in ("loss", "nll", "aux", "dropped", "grad_norm", "lr"):
        close(m[k], jm[k])
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnew), ctx,
                             "cpu")
    for a, b in zip(adamw.tree_leaves(new), adamw.tree_leaves(want)):
        close(a, b)
