"""The port's topology and capacity planning against the JAX package's:
Eq. (7) ratios, per-level member counts and capacities must be *equal*
(the same float64 numpy arithmetic and rounding), over the hierarchies
and modes ``tests/test_topology.py`` sweeps; the Eq. (8) penalties and the
model-level plan / gate config too.  No tolerance: equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jax_get_config
from repro.core import capacity as jcap
from repro.core import gating as jgating
from repro.core import topology as jtopo
from repro.models import model as jmodel
from repro.compat import make_mesh
from repro_torch.configs.base import get_config
from repro_torch.core import capacity, gating, topology
from repro_torch.models import model

SIZES = [(1,), (4,), (1, 4), (2, 1), (2, 2), (2, 4), (4, 8), (2, 2, 2),
         (2, 2, 4), (2, 2, 2, 2), (3, 2, 2)]


def plan_fields(p):
    return (p.tokens_per_device, p.num_experts, p.experts_per_rank, p.caps,
            p.ratios, p.mode, p.axis_sizes, p.level_axes, p.level_sizes,
            p.num_chunks)


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("mode", ["even", "ta", "hir"])
def test_dispatch_plans_equal(sizes, mode):
    for tokens, experts, k, cf in ((4096, 16, 2, 1.25), (1024, 64, 2, 2.0),
                                   (333, 32, 6, 1.0), (8, 160, 2, 4.0)):
        kw = dict(tokens_per_device=tokens, num_experts=experts, top_k=k,
                  capacity_factor=cf, axis_sizes=sizes, mode=mode)
        assert plan_fields(capacity.make_dispatch_plan(**kw)) == \
            plan_fields(jcap.make_dispatch_plan(**kw))
        for scale in ((1.0, 4.0), (1.0, 1.0, float("inf"))):
            a = capacity.make_dispatch_plan(level_beta_scale=scale, **kw)
            b = jcap.make_dispatch_plan(level_beta_scale=scale, **kw)
            assert plan_fields(a) == plan_fields(b)


def test_paper_model_plans():
    """The two plans this port trains with: one rank, and the 2x2 world at
    1024 tokens per rank."""
    p1 = capacity.make_dispatch_plan(tokens_per_device=2048, num_experts=64,
                                     top_k=2, capacity_factor=2.0,
                                     axis_sizes=(1,))
    p4 = capacity.make_dispatch_plan(tokens_per_device=1024, num_experts=64,
                                     top_k=2, capacity_factor=2.0,
                                     axis_sizes=(2, 2))
    assert p1.caps == (128,) and p4.caps == (120, 16)
    pen = gating.ta_penalties(p1.ratios, level_sizes=p1.level_sizes)
    assert pen[0] == 1.0 and pen[1] == pytest.approx(1e9)
    np.testing.assert_allclose(p4.ratios, (16 / 9, 16 / 9, 2 / 9))


@pytest.mark.parametrize("pods,epp", [(1, 4), (2, 4), (4, 8), (1, 1)])
def test_two_level_wrapper_and_bytes(pods, epp):
    kw = dict(tokens_per_device=4096, num_experts=32, top_k=2,
              capacity_factor=1.25, num_pods=pods, ep_per_pod=epp)
    for mode in ("even", "ta", "hir"):
        a, b = capacity.make_plan(mode=mode, **kw), jcap.make_plan(mode=mode,
                                                                   **kw)
        assert plan_fields(a) == plan_fields(b)
        assert plan_fields(capacity.align_to_chunks(a, 3)) == \
            plan_fields(jcap.align_to_chunks(b, 3))
        for codec in (None, "bf16"):
            assert capacity.a2a_bytes(a, 1024, 2, codec=codec) == \
                jcap.a2a_bytes(b, 1024, 2, codec=codec)


@pytest.mark.parametrize("sizes", SIZES)
def test_topology_pieces_equal(sizes):
    a, b = topology.tree_topology_nd(sizes), jtopo.tree_topology_nd(sizes)
    assert a.alpha == b.alpha and a.beta == b.beta
    np.testing.assert_array_equal(a.topo.level_matrix(), b.topo.level_matrix())
    np.testing.assert_array_equal(topology.per_level_ratios(a),
                                  jtopo.per_level_ratios(b))
    np.testing.assert_array_equal(topology.target_dispatch(a, 512.0, 2),
                                  jtopo.target_dispatch(b, 512.0, 2))
    assert topology.nested_spec(sizes) == jtopo.nested_spec(sizes)
    assert topology.axis_sizes_from_spec(topology.nested_spec(sizes)) == \
        jtopo.axis_sizes_from_spec(jtopo.nested_spec(sizes))
    assert capacity.default_axis_names(len(sizes)) == \
        jcap.default_axis_names(len(sizes))


def test_asymmetric_and_smoothing_equal():
    spec = ((2, 2), (2,))
    assert topology.axis_sizes_from_spec(spec) == \
        jtopo.axis_sizes_from_spec(spec)
    rng = np.random.default_rng(0)
    t, jt = topology.TreeTopology(((2, 2), (2, 2))), \
        jtopo.TreeTopology(((2, 2), (2, 2)))
    al = rng.uniform(1e-6, 1e-5, (8, 8))
    be = rng.uniform(1e-11, 1e-10, (8, 8))
    a, b = topology.smooth_profile(t, al, be), jtopo.smooth_profile(jt, al, be)
    assert a.alpha == b.alpha and a.beta == b.beta
    row = rng.uniform(1.0, 9.0, 16)
    for norm in ("sum", "softmax"):
        np.testing.assert_array_equal(topology.penalty_weights(row, norm),
                                      jtopo.penalty_weights(row, norm))


@pytest.mark.parametrize("norm", ["sum", "softmax"])
@pytest.mark.parametrize("sizes", [(1,), (4,), (2, 2), (2, 4), (2, 2, 2)])
def test_ta_penalties_equal(sizes, norm):
    p = jcap.make_dispatch_plan(tokens_per_device=1024, num_experts=64,
                                top_k=2, capacity_factor=2.0,
                                axis_sizes=sizes)
    for ls in (p.level_sizes, None):
        assert gating.ta_penalties(p.ratios, norm, ls) == \
            jgating.ta_penalties(p.ratios, norm, ls)


@pytest.mark.parametrize("aux_mode", ["lb", "ta", "hir", "none"])
def test_model_plan_and_gate_cfg_on_one_rank(aux_mode):
    jarch = jax_get_config("gpt3_medium_moe")
    mesh = make_mesh((1, 1), ("data", "model"))
    jctx = jmodel.build_ctx(jarch, mesh, seq_len=512, global_batch=4,
                            aux_mode=aux_mode)
    ctx = model.build_ctx(get_config("gpt3_medium_moe"), seq_len=512,
                          global_batch=4, aux_mode=aux_mode, device="cpu")
    assert plan_fields(ctx.plan) == plan_fields(jctx.plan)
    assert ctx.ep.hierarchy == jctx.ep.hierarchy
    assert ctx.gate_cfg.penalty_by_level == jctx.gate_cfg.penalty_by_level
