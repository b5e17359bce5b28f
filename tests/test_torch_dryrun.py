"""The port's meta-device dry-run (``repro_torch.launch.dryrun``), its cost
accounting (``launch/analysis.py``) and the two public functions of the
slice (``dispatch_moe``, ``make_generate_fns``), against the JAX package
on the CPU.

* parameter counts of all eleven archs at full width equal the
  reference's ``count_params`` of ``jax.eval_shape(init_model)`` (MoE
  archs counted globally, on one rank); ``active_params`` and
  ``model_flops_estimate`` equal the reference's arithmetic
  (``repro.launch.dryrun._active_params`` runs in a subprocess: that
  module sets ``XLA_FLAGS`` to 512 host devices when imported);
* a dry-run of each kind (train, prefill, decode) for reduced
  ``gpt3_medium_moe`` and ``olmo_1b`` on a (2, 2) hierarchy runs on meta
  tensors, and its forward's MoE collectives equal ``expected_inventory``
  once a MoE layer (beside the metrics' world means);
* ``collective_stats`` on a hand-built inventory gives the wire bytes the
  reference's ``collective_stats`` reads from the same collectives in
  HLO text;
* ``dispatch_moe`` equals ``make_engine(...)(...)`` and the reference's
  ``dispatch_moe`` at 1e-4 in float32;
* ``generate(fns=make_generate_fns(...))`` gives the reference's greedy
  tokens exactly.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.configs import base as jbase
from repro.core import capacity as jcapacity
from repro.core import gating as jgating
from repro.core.dispatch import base as jmoe_base
from repro.core.dispatch import engine as jengine_lib
from repro.launch import analysis as janalysis
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.serving import engine as jserving
from repro_torch.analysis import collective_check
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core import capacity, gating
from repro_torch.core.dispatch import base as moe_base
from repro_torch.core.dispatch import engine as engine_lib
from repro_torch.launch import analysis, dryrun
from repro_torch.models import model, transformer
from repro_torch.serving import engine
from test_torch_model import build_ctxs, build_params

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def full_ctx(arch):
    return model.build_ctx(arch, None, seq_len=4096, global_batch=256,
                           device="meta")


def test_param_counts_match_reference(mesh11, key):
    for aid in ARCH_IDS:
        jarch = jbase.get_config(aid)
        jctx = jmodel.build_ctx(jarch, mesh11, seq_len=4096,
                                global_batch=256)
        shapes = jax.eval_shape(
            lambda k, c=jctx: jtransformer.init_model(k, c), key)
        params = model.abstract_params(full_ctx(get_config(aid)))
        assert all(t.is_meta for t in jax.tree_util.tree_leaves(params))
        assert model.count_params(params) == jmodel.count_params(shapes), aid


_ACTIVE = """
import json, sys
from repro.launch import dryrun
from repro.configs.base import get_config
counts = json.loads(sys.argv[1])
print(json.dumps({a: dryrun._active_params(get_config(a), n)
                  for a, n in counts.items()}))
"""


def test_active_params_and_model_flops_match_reference():
    counts = {aid: model.count_params(model.abstract_params(
        full_ctx(get_config(aid)))) for aid in ARCH_IDS}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _ACTIVE, json.dumps(counts)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for aid in ARCH_IDS:
        arch, jarch = get_config(aid), jbase.get_config(aid)
        active = dryrun._active_params(arch, counts[aid])
        assert active == want[aid], aid
        for name, sh in INPUT_SHAPES.items():
            assert analysis.model_flops_estimate(
                arch, sh["seq_len"], sh["global_batch"], sh["kind"],
                active) == janalysis.model_flops_estimate(
                jarch, sh["seq_len"], sh["global_batch"], sh["kind"],
                active), (aid, name)


SHAPES = {"train": dict(seq_len=32, global_batch=8, kind="train"),
          "prefill": dict(seq_len=32, global_batch=8, kind="prefill"),
          "decode": dict(seq_len=64, global_batch=8, kind="decode")}


def test_dryrun_each_kind_on_meta_records_the_planned_collectives():
    for aid in ("gpt3_medium_moe", "olmo_1b"):
        arch = get_config(aid).reduced()
        for kind, sh in SHAPES.items():
            rec, run = dryrun.lower_one(aid, kind, (2, 2), arch=arch,
                                        shape=sh)
            assert rec["status"] == "ok" and rec["kind"] == kind
            assert rec["flops_per_chip"] > 0 and rec["hbm_bytes_per_chip"] > 0
            assert rec["batch_rows_per_rank"] == 2 and rec["fits"]
            fwd = run.inventory[:run.forward_calls]
            n_moe = sum(sub.ffn == "moe" for sub in transformer.layer_list(
                arch)) if arch.is_moe else 0
            expected = []
            if n_moe:
                m = arch.moe
                sc = collective_check.Scenario(
                    f"{aid}-{kind}", (2, 2),
                    "gather" if kind == "decode" else "a2a", False,
                    tokens=2 * (1 if kind == "decode" else sh["seq_len"]),
                    num_experts=m.num_experts, d_model=arch.d_model,
                    d_ff=m.d_ff_expert, top_k=m.top_k,
                    capacity_factor=m.capacity_factor, dtype=arch.dtype,
                    activation=arch.activation)
                if sc.path == "a2a":
                    assert run.ctx.plan.caps == collective_check._plan(
                        sc).caps
                expected = collective_check.expected_inventory(sc) * n_moe
                assert expected
            # beside the MoE chains only the metrics' world means: one f32
            # all-reduce over every rank a MoE layer, and in training the
            # loss mask's world count (one f32 element)
            rest = collective_check.match_inventory(kind, expected, fwd)
            counted = kind == "train"
            assert len(rest) == n_moe + counted, [v.message for v in rest]
            for v in rest:
                assert v.message.startswith("unexpected collective in the "
                                            "recording: all_reduce dtype=f32")
                assert v.message.endswith("groups=[[0, 1, 2, 3]]")
            if counted:
                assert rest[-1].message.endswith(
                    "all_reduce dtype=f32 elements=1 groups=[[0, 1, 2, 3]]")
            if kind == "train":
                parts = rec["arg_bytes_by_part"]
                numel = rec["params_per_rank"]
                assert parts == {"params": 4 * numel, "grads": 4 * numel,
                                 "opt": 8 * numel}
                assert rec["saved_bytes"] > 0
                assert run.forward_calls < len(run.inventory)
            else:
                assert rec["saved_bytes"] == 0


def test_full_width_record_skip_and_variant():
    rec, run = dryrun.lower_one("gpt3_medium_moe", "train_4k", "pod1")
    assert rec["status"] == "ok" and rec["axis_sizes"] == [16]
    assert rec["n_params"] == 3323906048
    assert rec["params_per_rank"] < rec["n_params"]
    assert rec["caps_by_level"] == list(run.ctx.plan.caps)
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["fits"] == (rec["arg_bytes"] + rec["saved_bytes"]
                           <= analysis.HBM_CAPACITY)
    for k in ("t_compute", "t_memory", "t_collective", "useful_ratio",
              "intra_node_bytes_per_chip", "model_flops"):
        assert rec[k] > 0, k
    assert rec["cross_node_bytes_per_chip"] == 0    # one node of 16
    skip, _ = dryrun.lower_one("whisper_tiny", "long_500k", "pod3")
    assert skip["status"] == "skipped" and skip["mesh"] == "pod3"
    arch, note = dryrun.arch_variant(get_config("olmo_1b"), "long_500k")
    assert arch.sliding_window == 8192 and "sliding-window" in note
    assert dryrun.resolve_mesh("pod2")[0].axis_sizes == (2, 16)
    specs = model.input_specs(get_config("internvl2_26b"), "prefill_32k",
                              dryrun.resolve_mesh("pod1")[0])
    assert specs["tokens"].shape == (2, 32768) and specs["frontend"].is_meta


def test_collective_stats_matches_reference():
    C = collective_check.Collective
    inv = [C("all_to_all", "bf16", 1000, ((0, 1), (2, 3))),
           C("all_to_all", "f32", 64, ((0, 2), (1, 3))),
           C("all_gather", "f32", 100, ((0, 1, 2, 3),)),
           C("all_reduce", "f32", 50, ((0, 1), (2, 3))),
           C("all_reduce", "i32", 8, ((0, 1, 2, 3),))]
    hlo = "\n".join([
        "%a = bf16[1000]{0} all-to-all(bf16[1000]{0} %x), "
        "replica_groups={{0,1},{2,3}}",
        "%b = f32[64]{0} all-to-all(f32[64]{0} %y), "
        "replica_groups={{0,2},{1,3}}",
        "%c = f32[400]{0} all-gather(f32[100]{0} %z), "
        "replica_groups={{0,1,2,3}}",
        "%d = f32[50]{0} all-reduce(f32[50]{0} %w), "
        "replica_groups={{0,1},{2,3}}",
        "%e = s32[8]{0} all-reduce(s32[8]{0} %v), "
        "replica_groups={{0,1,2,3}}"])
    got = analysis.collective_stats(inv, num_devices=4, devices_per_pod=2)
    want = janalysis.collective_stats(hlo, num_devices=4, devices_per_pod=2)
    assert got.intra_bytes == pytest.approx(want.ici_bytes)
    assert got.cross_bytes == pytest.approx(want.dci_bytes)
    assert got.counts == want.counts
    assert want.ici_bytes > 0 and want.dci_bytes > 0


def test_dispatch_moe_matches_engine_and_reference():
    d, f, N, K, T = 16, 32, 8, 2, 24
    rng = np.random.default_rng(3)
    p = {"gate": {"w": rng.standard_normal((d, N)).astype(np.float32)},
         "w_in": (rng.standard_normal((N, d, f)) / 4).astype(np.float32),
         "w_out": (rng.standard_normal((N, f, d)) / 6).astype(np.float32)}
    x = rng.standard_normal((T, d)).astype(np.float32)
    tp = {"gate": {"w": torch.from_numpy(p["gate"]["w"])},
          "w_in": torch.from_numpy(p["w_in"]),
          "w_out": torch.from_numpy(p["w_out"])}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    plan_kw = dict(tokens_per_device=T, num_experts=N, top_k=K,
                   capacity_factor=2.0, axis_sizes=(1,), mode="ta")
    cfg = moe_base.MoEConfig(d_model=d, d_ff=f, num_experts=N, top_k=K,
                             capacity_factor=2.0, activation="gelu",
                             dtype=torch.float32)
    ep = moe_base.EPSpec.from_axes(("data",), (1,))
    gate = gating.GateConfig(num_experts=N, top_k=K, aux_mode="lb")
    jcfg = jmoe_base.MoEConfig(d_model=d, d_ff=f, num_experts=N, top_k=K,
                               capacity_factor=2.0, activation="gelu",
                               dtype=jnp.float32)
    jep = jmoe_base.EPSpec.from_axes(("data",), (1,), model_axis=None)
    jgate = jgating.GateConfig(num_experts=N, top_k=K, aux_mode="lb")
    mesh = make_mesh((1,), ("data",))
    for name, use_pallas in (("a2a", False), ("a2a", True),
                             ("einsum", None)):
        kw = ({"plan": capacity.make_dispatch_plan(**plan_kw)}
              if name == "a2a" else {"capacity": T})
        jkw = ({"plan": jcapacity.make_dispatch_plan(**plan_kw)}
               if name == "a2a" else {"capacity": T})
        y, m = engine_lib.dispatch_moe(name, tp, torch.from_numpy(x),
                                       cfg=cfg, ep=ep, gate_cfg=gate,
                                       use_pallas=use_pallas, **kw)
        y2, _ = engine_lib.make_engine(name, cfg=cfg, ep=ep, gate_cfg=gate,
                                       use_pallas=use_pallas, **kw)(
            tp, torch.from_numpy(x))
        assert torch.equal(y, y2), name

        def body(pp, xx, name=name, jkw=jkw, use_pallas=use_pallas):
            return jengine_lib.dispatch_moe(name, pp, xx, cfg=jcfg, ep=jep,
                                            gate_cfg=jgate,
                                            use_pallas=use_pallas, **jkw)
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P()),
                               out_specs=(P(), P()), check_vma=False))
        with mesh:
            jy, jm = fn(jp, jnp.asarray(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(m["aux_loss"].numpy(),
                                   np.asarray(jm["aux_loss"]), **TOL)


def test_generate_fns_match_reference_greedy_tokens(mesh11, key):
    jparams, params = build_params(mesh11, key)
    jctx, ctx = build_ctxs(mesh11, aux_mode="none")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, ctx.arch.vocab_size, size=(2, 6)).astype(
        np.int32)
    want = jserving.generate(jparams, jctx, jnp.asarray(prompt), steps=5,
                             cache_len=16)
    fns = engine.make_generate_fns(ctx, 16)
    assert len(fns) == 3 and fns[2] is engine.sample
    got = engine.generate(params, ctx, torch.from_numpy(prompt), steps=5,
                          cache_len=16, fns=fns)
    again = engine.generate(params, ctx, torch.from_numpy(prompt), steps=5,
                            cache_len=16, fns=fns)
    plain = engine.generate(params, ctx, torch.from_numpy(prompt), steps=5,
                            cache_len=16)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert torch.equal(again.tokens, got.tokens)
    assert torch.equal(plain.tokens, got.tokens)


def test_abstract_params_and_input_specs_on_meta():
    arch = get_config("gpt3_medium_moe").reduced()
    ctx = model.build_ctx(arch, None, seq_len=32, global_batch=4,
                          device="cpu")
    real = model.init_params(ctx, torch.Generator().manual_seed(0))
    meta = model.abstract_params(ctx)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]
    assert [(tuple(a.shape), a.dtype) for a in leaves(meta)] == \
        [(tuple(b.shape), b.dtype) for b in leaves(real)]
    assert all(a.is_meta for a in leaves(meta))
    world = dryrun.resolve_mesh((2, 2))[0]
    wctx = model.build_ctx(arch, world, seq_len=64, global_batch=8,
                           device="meta")
    shard = model.abstract_params(wctx)
    assert shard["layers"][0]["ffn"]["w_in"].shape[0] == \
        arch.moe.num_experts // 4
    sh = {"seq_len": 64, "global_batch": 8, "kind": "decode"}
    specs = model.input_specs(arch, sh, world, ctx=wctx)
    assert specs["tokens"].shape == (2, 1)
    assert specs["cache"][0]["mixer"]["k"].shape[:2] == (2, 64)
    assert all(t.is_meta for t in leaves(specs["cache"]))
    train = model.input_specs(arch, {"seq_len": 32, "global_batch": 2,
                                     "kind": "train"}, world)
    assert train["tokens"].shape == (2, 32)      # fewer rows than ranks:
    assert set(train) == {"tokens", "labels", "loss_mask"}   # whole batch


def test_production_record_on_the_model_axis():
    """pod1 with its 16-wide ``model`` axis: OLMo-1B's train_4k rank holds
    a sixteenth of its attention, FFN and table (plus its norms whole),
    logs its model-axis all-reduces, and takes far less memory than on
    the hierarchy alone; Granite's 8 KV heads and odd vocabulary leave
    attention and the table whole; DeepSeek-V2-Lite (MLA by heads) runs
    on the 16-wide axis too, and xLSTM-350M, whose 4 heads 16 does not
    divide, on a model axis of 4, saying why."""
    rec, run = dryrun.lower_one("olmo_1b", "train_4k", "pod1")
    assert rec["tensor_parallel"] == 16 and rec["axis_sizes"] == [16]
    flat, _ = dryrun.lower_one("olmo_1b", "train_4k", "pod1", model=1)
    assert flat["tensor_parallel"] == 1
    assert rec["params_per_rank"] * 12 < flat["params_per_rank"]
    assert rec["bytes_per_device"] < flat["bytes_per_device"] / 3
    assert any(c.kind == "all_reduce" and len(c.groups[0]) == 16
               and c.groups[0] == tuple(range(16))
               for c in run.inventory)
    p = model.abstract_params(run.ctx)
    arch = get_config("olmo_1b")
    assert p["embed"]["table"].shape[0] == arch.vocab_size // 16
    assert p["layers"][0]["mixer"]["wq"].shape[1] == arch.d_model // 16
    assert p["layers"][0]["ffn"]["w_out"].shape[0] == arch.d_ff // 16
    _, grun = dryrun.lower_one("granite_3_2b", "decode_32k", "pod1")
    gp = model.abstract_params(grun.ctx)
    garch = get_config("granite_3_2b")
    assert gp["embed"]["table"].shape[0] == garch.vocab_size
    assert gp["layers"][0]["mixer"]["wk"].shape[1] == \
        garch.num_kv_heads * garch.head_dim_
    assert gp["layers"][0]["ffn"]["w_in"].shape[1] == garch.d_ff // 16
    ds, _ = dryrun.lower_one("deepseek_v2_lite_16b", "decode_32k", "pod1")
    assert ds["tensor_parallel"] == 16 and ds["note"] == ""
    xl, _ = dryrun.lower_one("xlstm_350m", "decode_32k", "pod1")
    assert xl["tensor_parallel"] == 4
    assert "model axis 16 -> 4" in xl["note"] and "4 heads" in xl["note"]
