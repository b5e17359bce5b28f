"""The wire codecs and the int8 grouped FFN (K7's plain version) of the port
against the JAX package on the CPU.

- Registry, resolution and error messages of ``core.dispatch.wire``
  (mirroring ``tests/test_wire_codec.py``).
- ``encode``: the int8 and float8_e4m3fn payloads bit-equal to the
  reference's and the f32 scales equal, over shapes, block ranks and
  amplitudes, with all-zero blocks (scale 1) and zero slack rows; the
  decode round trip equal.
- ``capacity.a2a_bytes`` under every wire: equal, the scale sideband
  included.
- ``grouped_ffn_ragged_quant`` (K7's plain version) against the
  reference's plain version and its Pallas kernel under the interpreter,
  over ragged widths, rows_valid below the width, empty segments, gelu and
  swiglu: rtol = atol = 1e-5 (the integer sums are exact on both sides;
  the dequantized activation and the f32 down-projection round in another
  order), rows past rows_valid exact zeros; the straight-through
  gradients against the reference's ``jax.vjp`` at rtol = atol = 1e-4.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import capacity as jcap
from repro.core.dispatch import wire as jwire
from repro.kernels.moe_gemm import ops as jgemm_ops
from repro.kernels.moe_gemm import ref as jref
from repro_torch.configs.base import get_config
from repro_torch.core import capacity
from repro_torch.core.dispatch import base, transport, wire
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.moe_gemm import ref
from repro_torch.models import model

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def bits(a):
    """The payload's bit patterns as unsigned integers, whatever its dtype
    (torch or jax)."""
    if torch.is_tensor(a):
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
        return a.contiguous().view(width[a.dtype.itemsize]).numpy() \
            .view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# registry and resolution
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert set(wire.CODECS) == set(jwire.CODECS)
    for name, codec in wire.CODECS.items():
        ref_codec = jwire.CODECS[name]
        assert type(codec).__name__ == type(ref_codec).__name__
        for field in ("name", "wire_dtype", "scaled", "quantize_compute"):
            assert getattr(codec, field) == getattr(ref_codec, field), field
        assert codec.wire_bytes_per_elem == ref_codec.wire_bytes_per_elem
        assert getattr(codec, "qmax", None) == getattr(ref_codec, "qmax",
                                                       None)
    assert wire.CODECS["fp8e4m3"].dtype == torch.float8_e4m3fn
    assert wire.CODECS["int8"].quantize_compute
    assert not wire.CODECS["fp8e4m3"].quantize_compute


def test_resolution_and_errors():
    assert wire.get_codec(None) is None and wire.get_codec("") is None
    assert wire.get_codec("int8") is wire.CODECS["int8"]
    mine = wire.ScaledCodec(name="my4bit", wire_dtype="int8", qmax=7.0)
    assert wire.get_codec(mine) is mine
    for mod in (wire, jwire):
        with pytest.raises(ValueError, match=r"registered codecs.*bf16"):
            mod.get_codec("int4")
    with pytest.raises(ValueError, match="registered codecs"):
        base.MoEConfig(d_model=8, d_ff=16, num_experts=4, top_k=2,
                       wire_codec="nope")
    with pytest.raises(ValueError, match="registered codecs"):
        model.build_ctx(get_config("gpt3_medium_moe").reduced(),
                        seq_len=32, global_batch=4, wire_codec="int4",
                        device="cpu")
    cfg = base.MoEConfig(d_model=8, d_ff=16, num_experts=4, top_k=2,
                         wire_codec="fp8e4m3")
    assert cfg.wire_codec is wire.CODECS["fp8e4m3"]


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["int8", "fp8e4m3", "bf16"])
@pytest.mark.parametrize("shape,block_ndim,amp", [
    ((3, 5, 8, 16), 2, 1.0), ((2, 2, 4, 6, 32), 2, 100.0),
    ((4, 7, 16), 2, 1e-3), ((6, 40), 1, 3.0)])
def test_encode_payload_bit_equal(name, shape, block_ndim, amp):
    rng = np.random.default_rng(sum(shape))
    x = (amp * rng.standard_normal(shape)).astype(np.float32)
    lead = shape[:-block_ndim]
    x.reshape(-1, *shape[-block_ndim:])[0] = 0.0     # an all-zero block
    if block_ndim == 2:
        x[..., -1, :] = 0.0                          # zero slack rows
    codec, jcodec = wire.CODECS[name], jwire.CODECS[name]
    payload, scale = codec.encode(t(x), block_ndim=block_ndim)
    jpayload, jscale = jcodec.encode(jnp.asarray(x), block_ndim=block_ndim)
    assert payload.dtype == codec.dtype and payload.shape == x.shape
    np.testing.assert_array_equal(bits(payload), bits(jpayload))
    if jscale is None:
        assert scale is None
        return
    assert scale.dtype == torch.float32 and tuple(scale.shape) == lead
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert scale.reshape(-1)[0] == 1.0               # all-zero block
    s = scale.reshape(lead + (1,) * block_ndim)
    y = codec.decode(payload, s, torch.float32)
    jy = jcodec.decode(jpayload, jnp.asarray(s.numpy()), jnp.float32)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert (y.reshape(-1, *shape[-block_ndim:])[0] == 0).all()
    if block_ndim == 2:
        assert (y[..., -1, :] == 0).all()


@pytest.mark.parametrize("codec", ["", "bf16", "int8", "fp8e4m3"])
@pytest.mark.parametrize("sizes,tokens", [((2, 2), 64), ((2, 4), 512),
                                          ((2, 2, 2), 256), ((4,), 128)])
def test_a2a_bytes_equal(codec, sizes, tokens):
    kw = dict(tokens_per_device=tokens, num_experts=16, top_k=2,
              capacity_factor=2.0, axis_sizes=sizes, mode="ta")
    plan = capacity.make_dispatch_plan(**kw)
    jplan = jcap.make_dispatch_plan(**kw)
    for bpe in (2, 4):
        got = capacity.a2a_bytes(plan, 64, bpe, codec=codec)
        want = jcap.a2a_bytes(jplan, 64, bpe, codec=codec)
        assert got == {k: (tuple(v) if k == "by_level" else v)
                       for k, v in want.items()}
    if codec == "int8":
        raw = capacity.a2a_bytes(plan, 64, 4)
        for s in plan.active_stages():
            segs = plan.experts_per_rank * plan.stage_dests(s)
            assert got["by_level"][s] == raw["by_level"][s] // 4 + segs * 4


# ---------------------------------------------------------------------------
# K7's plain version
# ---------------------------------------------------------------------------


def quant_case(seed, layout, d=32, f=64):
    """Segments, experts, rows_valid and zero-slot inputs: rows at or past
    a segment's valid count are zero, as routing delivers them."""
    rng = np.random.default_rng(seed)
    if layout == "stage_segments":          # the 2x2 plan's chunk shape
        E = 3
        offs, exps = transport.stage_segments(E, ((2, 5), (4, 2)))
        widths = np.diff(offs)
        valid = np.array([rng.integers(0, w + 1) for w in widths], np.int32)
        valid[0] = widths[0]
    else:                                   # ragged widths, empty segments
        E = 4
        widths = np.array([5, 0, 7, 3, 6], np.int64)
        exps = (0, 1, 2, 2, 3)
        offs = tuple(int(o) for o in np.concatenate([[0],
                                                     np.cumsum(widths)]))
        valid = np.array([5, 0, 4, 0, 6], np.int32)
    R = offs[-1]
    x = rng.standard_normal((R, d)).astype(np.float32)
    rows = np.arange(R)
    seg = np.searchsorted(np.asarray(offs)[1:], rows, side="right")
    dead = rows - np.asarray(offs)[seg] >= valid[seg]
    x[dead] = 0.0
    wi, wg, wo = ((rng.standard_normal(s) * 0.3).astype(np.float32)
                  for s in ((E, d, f), (E, d, f), (E, f, d)))
    g = rng.standard_normal((R, d)).astype(np.float32)
    return offs, exps, valid, x, wi, wg, wo, g, dead


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("layout", ["stage_segments", "ragged"])
def test_quant_ffn_matches_reference_and_interpreted_kernel(activation,
                                                            layout):
    offs, exps, valid, x, wi, wg, wo, g, dead = quant_case(5, layout)
    wg = wg if activation == "swiglu" else None
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (x, wi, wg, wo)]
    want_ref = jref.grouped_ffn_ragged_quant_ref(
        jargs[0], offs, exps, jnp.asarray(valid), jargs[1], jargs[2],
        jargs[3], activation=activation)
    want_kernel = jgemm_ops.grouped_ffn_ragged_quant(
        jargs[0], offs, exps, jnp.asarray(valid), jargs[1], jargs[2],
        jargs[3], activation=activation, use_pallas=True)
    np.testing.assert_allclose(np.asarray(want_kernel), np.asarray(want_ref),
                               rtol=1e-5, atol=1e-5)
    got = ref.grouped_ffn_ragged_quant_ref(
        t(x), offs, exps, t(valid), t(wi), None if wg is None else t(wg),
        t(wo), activation=activation)
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert (got.numpy()[dead] == 0).all()
    via_entry = gemm_ops.grouped_ffn_ragged_quant(
        t(x), offs, exps, t(valid), t(wi), None if wg is None else t(wg),
        t(wo), activation=activation)
    np.testing.assert_array_equal(via_entry.detach().numpy(), got.numpy())


def test_quantizers_match_reference():
    offs, exps, valid, x, wi, *_ = quant_case(9, "ragged")
    q, s = ref.quantize_segments(t(x), offs)
    jq, js = jref.quantize_segments(jnp.asarray(x), offs)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1] == 1.0                          # the empty segment
    q, s = ref.quantize_experts(t(wi))
    jq, js = jref.quantize_experts(jnp.asarray(wi))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
def test_quant_ffn_straight_through_grads(activation):
    offs, exps, valid, x, wi, wg, wo, g, _ = quant_case(13, "stage_segments")
    wg = wg if activation == "swiglu" else None

    def jfn(x_, wi_, wo_, wg_):
        return jgemm_ops.grouped_ffn_ragged_quant(
            x_, offs, exps, jnp.asarray(valid), wi_, wg_, wo_,
            activation=activation, use_pallas=False)
    jargs = [jnp.asarray(a) for a in (x, wi, wo)] + \
        ([jnp.asarray(wg)] if wg is not None else [None])
    jy, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(g))
    ts = [t(a).requires_grad_(True) for a in (x, wi, wo)]
    wgt = t(wg).requires_grad_(True) if wg is not None else None
    y = gemm_ops.grouped_ffn_ragged_quant(ts[0], offs, exps, t(valid), ts[1],
                                          wgt, ts[2], activation=activation)
    y.backward(t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(ts + ([wgt] if wgt is not None else []), jgrads):
        assert got.grad is not None and got.grad.abs().max() > 0
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
