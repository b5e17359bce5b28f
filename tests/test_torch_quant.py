"""The int8 ragged grouped FFN's (K7's) weight quantization hoisted out of
the chunk loop, its expert-span tiles and its per-segment row ids, on the
CPU.

- ``moe_gemm.ops.quantize_expert_weights`` handed to
  ``grouped_ffn_ragged_quant`` (``qweights=``): outputs and
  straight-through gradients bit-identical to quantizing in the call, and
  the output within rtol = atol = 1e-5 of the JAX package's
  ``grouped_ffn_ragged_quant_ref`` (the integer sums are exact on both
  sides; the dequantized activation and the f32 down-projection round in
  another order), gelu and swiglu, on the pipelined chunk's segment shape
  and on ragged widths with empty segments.
- The ``a2a_pipelined`` engine under the ``int8`` codec quantizes each
  expert weight once a forward, not once a chunk (counted by a wrapper of
  ``ref.quantize_experts``), with output and gradients bit-identical to
  the per-chunk quantization; on the reduced ``gpt3_medium_moe`` a
  forward quantizes once a layer and weight.
- ``moe_fused.ops.plan_expert_tiles``: every row covered once, no tile
  across two experts, spans over 64 rows split, empty experts and
  zero-width segments skipped, at the full-width 2x2 plan's layouts too.
- ``moe_gemm.ref.quantize_segments`` with its row-to-segment ids cached on
  the device: bit-equal to the computation it replaced on the reduced
  pipelined layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.moe_gemm import ref as jref
from repro_torch.configs.base import get_config
from repro_torch.core import capacity, gating
from repro_torch.core.dispatch import base, engine, transport
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.moe_fused.ops import (TILE_ROWS, expert_tiles_on,
                                               plan_expert_tiles)
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.moe_gemm import ref
from repro_torch.models import model, transformer

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def quant_case(seed, layout, d=32, f=64):
    """Segments, experts, rows_valid and zero-slot inputs (rows at or past
    a segment's valid count are zero, as routing delivers them)."""
    rng = np.random.default_rng(seed)
    if layout == "chunk":                    # the 2x2 plan's chunk shape
        E = 3
        offs, exps = transport.stage_segments(E, ((2, 15), (4, 2)))
    else:                                    # ragged widths, empty segments
        E = 4
        widths = np.array([5, 0, 7, 3, 6], np.int64)
        exps = (0, 1, 2, 2, 3)
        offs = tuple(int(o) for o in np.concatenate([[0],
                                                     np.cumsum(widths)]))
    widths = np.diff(offs)
    valid = np.array([rng.integers(0, w + 1) for w in widths], np.int32)
    R = offs[-1]
    x = rng.standard_normal((R, d)).astype(np.float32)
    rows = np.arange(R)
    seg = np.searchsorted(np.asarray(offs)[1:], rows, side="right")
    x[rows - np.asarray(offs)[seg] >= valid[seg]] = 0.0
    wi, wg, wo = ((rng.standard_normal(s) * 0.3).astype(np.float32)
                  for s in ((E, d, f), (E, d, f), (E, f, d)))
    g = rng.standard_normal((R, d)).astype(np.float32)
    return offs, exps, valid, x, wi, wg, wo, g


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("layout", ["chunk", "ragged"])
def test_hoisted_weights_bit_identical(activation, layout):
    offs, exps, valid, x, wi, wg, wo, g = quant_case(3, layout)
    wg = wg if activation == "swiglu" else None
    runs = []
    for hoist in (False, True):
        ts = [t(a).requires_grad_(True) for a in (x, wi, wo)]
        wgt = None if wg is None else t(wg).requires_grad_(True)
        qw = gemm_ops.quantize_expert_weights(ts[1], wgt) if hoist else None
        y = gemm_ops.grouped_ffn_ragged_quant(
            ts[0], offs, exps, t(valid), ts[1], wgt, ts[2],
            activation=activation, qweights=qw)
        y.backward(t(g))
        runs.append([y.detach()] + [a.grad for a in ts + [wgt]
                                    if a is not None])
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    want = jref.grouped_ffn_ragged_quant_ref(
        jnp.asarray(x), offs, exps, jnp.asarray(valid), jnp.asarray(wi),
        None if wg is None else jnp.asarray(wg), jnp.asarray(wo),
        activation=activation)
    np.testing.assert_allclose(runs[1][0].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # the weights are stored transposed, the reduction axis innermost
    q, s, qg, sg = gemm_ops.quantize_expert_weights(t(wi), None)
    jq, js = jref.quantize_experts(jnp.asarray(wi))
    np.testing.assert_array_equal(q.transpose(1, 2).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert qg is None and sg is None and q.is_contiguous()


def counting(monkeypatch):
    """Count the calls of ``ref.quantize_experts`` (every weight
    quantization of the port goes through it)."""
    calls = []
    real = ref.quantize_experts

    def wrapped(w, **kw):
        calls.append(tuple(w.shape))
        return real(w, **kw)
    monkeypatch.setattr(ref, "quantize_experts", wrapped)
    return calls


D, F, N, K, T = 16, 32, 4, 2, 64


@pytest.mark.parametrize("num_chunks", [2, 4])
def test_engine_quantizes_weights_once_a_forward(monkeypatch, num_chunks):
    cfg = base.MoEConfig(d_model=D, d_ff=F, num_experts=N, top_k=K,
                         capacity_factor=1.0, dtype=torch.float32,
                         wire_codec="int8")
    gate_cfg = gating.GateConfig(num_experts=N, top_k=K, aux_mode="lb")
    plan = capacity.make_plan(tokens_per_device=T, num_experts=N, top_k=K,
                              capacity_factor=1.0, num_pods=1, ep_per_pod=1,
                              mode="even", round_multiple=1)
    eng = engine.make_engine("a2a_pipelined", cfg=cfg, ep=base.EPSpec(),
                             gate_cfg=gate_cfg, plan=plan,
                             num_chunks=num_chunks)
    rng = np.random.default_rng(7)
    params = base.init_moe_params(cfg, base.EPSpec(), gate_cfg,
                                  torch.Generator().manual_seed(0), "cpu")
    x = rng.standard_normal((T, D)).astype(np.float32)
    r = t(rng.standard_normal((T, D)).astype(np.float32))
    calls = counting(monkeypatch)

    def run():
        p = {k: (v.detach().clone().requires_grad_(True) if k != "gate"
                 else {"w": v["w"].detach().clone().requires_grad_(True)})
             for k, v in params.items()}
        xt = t(x).requires_grad_(True)
        y, m = eng(p, xt)
        (torch.sum(y * r) + m["aux_loss"]).backward()
        return [y.detach(), xt.grad, p["gate"]["w"].grad] + [
            p[k].grad for k in ("w_in", "w_gate", "w_out")]

    hoisted = run()
    assert calls == [(N, D, F)] * 2              # w_in and w_gate, once
    calls.clear()
    monkeypatch.setattr(gemm_ops, "quantize_expert_weights",
                        lambda *a, **kw: None)  # quantize in every call
    per_chunk = run()
    assert calls == [(N, D, F)] * 2 * num_chunks
    for got, want in zip(hoisted, per_chunk):
        assert torch.equal(got, want)


def test_model_forward_quantizes_once_a_layer_and_weight(monkeypatch):
    arch = get_config("gpt3_medium_moe").reduced()
    ctx = model.build_ctx(arch, seq_len=32, global_batch=4, aux_mode="ta",
                          dispatch="a2a_pipelined", a2a_num_chunks=2,
                          wire_codec="int8", device="cpu")
    assert ctx.a2a_num_chunks == 2
    params = model.init_params(ctx, torch.Generator().manual_seed(0))
    batch = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=32,
                                   global_batch=4)).batch(0)
    weights = [(k, lp["ffn"][k].shape) for lp in params["layers"]
               for k in ("w_in", "w_gate") if k in lp.get("ffn", {})]
    assert weights                               # every layer is MoE here
    calls = counting(monkeypatch)
    with torch.no_grad():
        loss, _ = transformer.loss_fn(params, batch, ctx)
    assert calls == [tuple(s) for _, s in weights]
    assert torch.isfinite(loss)


FULL_22 = transport.stage_segments(16, ((2, 120), (4, 16)))
CHUNK_22 = transport.stage_segments(16, ((2, 15), (4, 2)))


@pytest.mark.parametrize("offs,exps,tiles_per_expert", [
    (*CHUNK_22, [1] * 16),                      # 38 rows an expert
    (*FULL_22, [5] * 16),                       # 304 rows: 4 x 64 + 48
    ((0, 5, 5, 10, 100, 100, 170), (0, 1, 0, 0, 2, 3), [2, 0, 0, 2]),
    ((0, 0, 64, 64, 129), (0, 1, 1, 3), [0, 1, 0, 2]),
    ((0, 10, 20, 30), (1, 0, 1), [1, 2]),       # a split expert: two spans
])
def test_plan_expert_tiles(offs, exps, tiles_per_expert):
    tiles = plan_expert_tiles(tuple(offs), tuple(exps))
    assert tiles.dtype == np.int32 and tiles.shape[1] == 3
    R = offs[-1]
    cover = np.zeros(R, np.int64)
    seg_of = np.searchsorted(np.asarray(offs)[1:], np.arange(R),
                             side="right")
    counts = np.zeros(len(tiles_per_expert), np.int64)
    for row0, e, rows in tiles:
        assert 0 < rows <= TILE_ROWS
        cover[row0:row0 + rows] += 1
        assert (np.asarray(exps)[seg_of[row0:row0 + rows]] == e).all()
        counts[e] += 1
    assert (cover == 1).all()                    # every row, once
    assert counts.tolist() == tiles_per_expert
    dev_tiles, seg_start = expert_tiles_on(tuple(offs), tuple(exps), "cpu")
    assert torch.equal(dev_tiles, torch.from_numpy(tiles))
    assert seg_start.tolist() == list(offs[:-1])
    assert expert_tiles_on(tuple(offs), tuple(exps), "cpu")[0] is dev_tiles


def old_quantize_segments(x, seg_offsets, qmax=127.0):
    """``quantize_segments`` as it was, its row ids built on every call."""
    offs = np.asarray([int(o) for o in seg_offsets], np.int64)
    S = len(offs) - 1
    seg_ids = torch.as_tensor(
        np.searchsorted(offs[1:], np.arange(int(offs[-1])), side="right"),
        device=x.device)
    xf = x.to(torch.float32)
    row_max = xf.abs().amax(dim=-1)
    absmax = torch.zeros(S, dtype=torch.float32, device=x.device) \
        .scatter_reduce(0, seg_ids, row_max, "amax")
    scale = torch.where(absmax > 0, absmax,
                        torch.full_like(absmax, qmax)) / qmax
    q = torch.clamp(torch.round(xf / scale[seg_ids][:, None]), -qmax, qmax)
    return q.to(torch.int8), scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_segments_cached_ids_bit_equal(dtype):
    """On the reduced gpt3_medium_moe's pipelined int8 layout (a 2x2 plan,
    2 chunks) and its ragged counterpart with an empty segment."""
    arch = get_config("gpt3_medium_moe").reduced()
    ctx = model.build_ctx(arch, seq_len=32, global_batch=4, aux_mode="ta",
                          dispatch="a2a_pipelined", a2a_num_chunks=2,
                          wire_codec="int8", device="cpu")
    plan = ctx.plan
    k = ctx.a2a_num_chunks
    E_l = arch.moe.num_experts // 4
    layouts = [transport.stage_segments(
        E_l, ((2, plan.caps[0] // k), (4, max(1, plan.caps[-1] // k))))[0],
        (0, 5, 5, 12, 40)]
    rng = np.random.default_rng(1)
    for offs in layouts:
        x = torch.from_numpy(rng.standard_normal(
            (offs[-1], arch.d_model)).astype(np.float32)).to(dtype)
        x[offs[1]:offs[2]] = 0                     # an all-zero segment
        q, s = ref.quantize_segments(x, offs)
        q0, s0 = old_quantize_segments(x, offs)
        assert torch.equal(q, q0) and torch.equal(s, s0)
        ids = ref.segment_ids_on(tuple(offs), "cpu")
        assert ids is ref.segment_ids_on(tuple(offs), "cpu")   # cached
        assert ids.dtype == torch.int64 and ids.shape == (offs[-1],)
