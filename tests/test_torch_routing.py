"""Routing and the three kernels of the staged a2a path, port against the
JAX package on the CPU.

- ``score_matrix`` / ``select`` / ``build_indices`` on the same gate
  output (made by numpy, with ties): bit-equal (``slot_to_token``,
  ``slot_w``, ``inv_idx``, ``inv_w``, ``rows_per_expert``).
- ``route`` + ``build_indices`` from the same weights and tokens on a unit
  world and as rank 0 of 2x2 / 2x2x2 hierarchies (the reference's
  ``_route_as_rank0`` trick: unit mesh axes, only ``axis_index`` is read):
  indices bit-equal, weights within 1e-6 (the gate's float32 softmax may
  round differently in the two frameworks).
- K1 permute, K2 unpermute and K3 ragged grouped FFN: the port's plain
  versions against the JAX kernels under the Pallas interpreter, forward
  and ``jax.vjp``; the port's ``autograd.Function`` backwards (driven on
  the CPU with the plain forward) against the same ``jax.vjp``.
  Tolerance rtol = atol = 1e-4 in float32; 1e-5 for K1 and K2 on the
  sentinel-heavy layouts of a real route on a reduced 2x2 plan (71% of
  the slots sentinels, 14% of the picks dropped), with every slot a
  sentinel and with every pick dropped, where the backwards' discard rows
  must give the reference's ``mode="drop"`` gradients and no row of
  their buffers may take more than K adds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.compat import make_mesh, shard_map
from repro.core import capacity as jcap
from repro.core import dispatch as jdispatch
from repro.core import gating as jgating
from repro.core.dispatch import routing as jrouting
from repro.kernels.moe_gemm import ops as jgemm_ops
from repro.kernels.moe_permute import ops as jpermute_ops
from repro_torch.core import capacity, gating
from repro_torch.core.dispatch import base, routing, transport
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                              grouped_ffn_ragged_ref)
from repro_torch.kernels.moe_permute import ops as permute_ops
from repro_torch.kernels.moe_permute.ref import permute_ref, unpermute_ref

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got), np.asarray(want), **(tol or TOL))


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def t(a):
    return torch.from_numpy(np.array(a))


def gate_out_with_ties(rng, T, N, K):
    """topk picks and weights quantized to a few levels, so many weights
    tie across tokens (the order ``select`` must reproduce)."""
    idx = np.stack([rng.permutation(N)[:K] for _ in range(T)]).astype(
        np.int32)
    w = rng.integers(1, 4, (T, K)).astype(np.float32) / 4.0
    return idx, w


@pytest.mark.parametrize("T,N,K,cap", [(24, 8, 2, 5), (16, 4, 2, 16),
                                       (32, 16, 4, 3)])
def test_select_and_build_indices_bit_equal(T, N, K, cap):
    rng = np.random.default_rng(T + N)
    idx, w = gate_out_with_ties(rng, T, N, K)
    x = rng.standard_normal((T, 8)).astype(np.float32)
    eids = np.arange(N).reshape(2, N // 2)
    jgo = {"topk_idx": jnp.asarray(idx), "topk_weight": jnp.asarray(w)}
    go = {"topk_idx": t(idx), "topk_weight": t(w)}
    jsc = jrouting.score_matrix(jgo, N)
    sc = routing.score_matrix(go, N)
    equal(sc, jsc)
    jsel = jrouting.select(jsc[jnp.asarray(eids)], jnp.asarray(x), cap,
                           eids=jnp.asarray(eids), with_buf=False)
    sel = routing.select(sc[t(eids)], t(x), cap, eids=t(eids))
    for a, b in ((sel.w, jsel.w), (sel.idx, jsel.idx),
                 (sel.valid, jsel.valid), (sel.eid, jsel.eid)):
        equal(a, b)
    # a second stage view: the same selection padded to a chunk multiple
    jsel2 = jrouting.pad_selection(jsel, axis=2, multiple=3)
    sel2 = routing.pad_selection(sel, axis=2, multiple=3)
    jdi = jrouting.build_indices(((0, jsel), (1, jsel2)), jnp.asarray(idx), T)
    di = routing.build_indices(((0, sel), (1, sel2)), t(idx), T)
    for a, b in zip(di[:4] + (di.rows_per_expert,),
                    jdi[:4] + (jdi.rows_per_expert,)):
        equal(a, b)
    assert di.shapes == jdi.shapes
    assert di.stage_spans() == jdi.stage_spans()
    assert di.expert_spans() == jdi.expert_spans()
    half = routing.slice_selection(sel2, 2, 0, sel2.idx.shape[2] // 3)
    jhalf = jrouting.slice_selection(jsel2, 2, 0, jsel2.idx.shape[2] // 3)
    equal(half.idx, jhalf.idx)


def _names(n):
    return jcap.default_axis_names(n)


@pytest.mark.parametrize("sizes,aux_mode", [((1,), "ta"), ((2, 2), "ta"),
                                            ((2, 2), "hir"),
                                            ((2, 2, 2), "lb")])
def test_route_matches_reference_as_rank0(sizes, aux_mode):
    T, N, K, d = 48, 16, 2, 8
    names = _names(len(sizes))
    plan_kw = dict(tokens_per_device=T, num_experts=N, top_k=K,
                   capacity_factor=1.5, axis_sizes=sizes, mode="ta")
    jplan = jcap.make_dispatch_plan(**plan_kw)
    plan = capacity.make_dispatch_plan(**plan_kw)
    pen = jgating.ta_penalties(jplan.ratios, level_sizes=jplan.level_sizes)
    pen = pen + (pen[-1],) * max(0, 3 - len(pen))
    jcfg = jdispatch.MoEConfig(d_model=d, d_ff=16, num_experts=N, top_k=K,
                               dtype=jnp.float32)
    jep = jdispatch.EPSpec.from_axes(names, sizes)
    jgate = jgating.GateConfig(num_experts=N, top_k=K, aux_mode=aux_mode,
                               penalty_by_level=pen)
    rng = np.random.default_rng(len(sizes))
    gw = rng.standard_normal((d, N)).astype(np.float32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    mesh = make_mesh((1,) * len(names), names)

    def body(p, xx):
        routed = jrouting.route(p, xx, jcfg, jep, jplan, jgate,
                                with_bufs=False)
        di = jrouting.build_indices(routed.sels, routed.gate_out["topk_idx"],
                                    T)
        return di[:4] + (di.rows_per_expert, routed.aux, routed.levels)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(),) * 7, check_vma=False))
    with mesh:
        want = fn({"gate": {"w": jnp.asarray(gw)}}, jnp.asarray(x))

    cfg = base.MoEConfig(d_model=d, d_ff=16, num_experts=N, top_k=K,
                         dtype=torch.float32)
    ep = base.EPSpec.from_axes(names, sizes)
    gate = gating.GateConfig(num_experts=N, top_k=K, aux_mode=aux_mode,
                             penalty_by_level=pen)
    routed = routing.route({"gate": {"w": t(gw)}}, t(x), cfg, ep, plan, gate,
                           coords=(0,) * len(sizes))
    di = routing.build_indices(routed.sels, routed.gate_out["topk_idx"], T)
    s2t, slot_w, inv_idx, inv_w, rpe, aux, levels = want
    equal(di.slot_to_token, s2t)
    equal(di.inv_idx, inv_idx)
    equal(di.rows_per_expert, rpe)
    equal(routed.levels, levels)
    close(di.slot_w, slot_w, rtol=1e-6, atol=1e-6)
    close(di.inv_w, inv_w, rtol=1e-6, atol=1e-6)
    close(routed.aux, aux, rtol=1e-6, atol=1e-6)
    stages = transport.plan_stages(plan, ep)
    assert [s.num_dests for s in stages] == \
        [s.num_dests for s in jdispatch.transport.plan_stages(jplan, jep)]


# ---------------------------------------------------------------------------
# K1 / K2: permute and unpermute
# ---------------------------------------------------------------------------


def permute_case(seed=0, T=12, S=20, K=2, d=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    tok = rng.integers(0, T + 1, S).astype(np.int32)          # T = sentinel
    y = rng.standard_normal((S, d)).astype(np.float32)
    inv_idx = rng.integers(0, S + 1, (T, K)).astype(np.int32)  # S = sentinel
    inv_w = rng.uniform(0, 1, (T, K)).astype(np.float32)
    inv_w[inv_idx == S] = 0.0
    g_perm = rng.standard_normal((S, d)).astype(np.float32)
    g_un = rng.standard_normal((T, d)).astype(np.float32)
    return x, tok, y, inv_idx, inv_w, g_perm, g_un


TOL_2X2 = dict(rtol=1e-5, atol=1e-5)


def layout_2x2(layout, d=16):
    """``permute_case``'s arrays on the indices of a real ``route`` +
    ``build_indices`` as rank 0 of a reduced 2x2 plan (64 tokens, 16
    experts, top-2, capacity factor 2.0: caps (32, 8), 384 slots, 71% of
    them sentinels, 14% of the picks dropped); ``all_sentinel`` and
    ``all_dropped`` keep its shapes with every slot a sentinel and every
    pick dropped (``inv_w`` kept: a dropped pick's weight gets gradient
    0)."""
    T, N, K = 64, 16, 2
    sizes = (2, 2)
    plan = capacity.make_dispatch_plan(
        tokens_per_device=T, num_experts=N, top_k=K, capacity_factor=2.0,
        axis_sizes=sizes, mode="ta")
    pen = gating.ta_penalties(plan.ratios, level_sizes=plan.level_sizes)
    pen = tuple(pen) + (pen[-1],) * max(0, 3 - len(pen))
    cfg = base.MoEConfig(d_model=d, d_ff=16, num_experts=N, top_k=K,
                         dtype=torch.float32)
    ep = base.EPSpec.from_axes(_names(2), sizes)
    gate = gating.GateConfig(num_experts=N, top_k=K, aux_mode="ta",
                             penalty_by_level=pen)
    rng = np.random.default_rng(0)
    gw = rng.standard_normal((d, N)).astype(np.float32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    routed = routing.route({"gate": {"w": t(gw)}}, t(x), cfg, ep, plan, gate,
                           coords=(0, 0))
    di = routing.build_indices(routed.sels, routed.gate_out["topk_idx"], T)
    S = di.num_slots
    tok = di.slot_to_token.numpy().copy()
    inv_idx = di.inv_idx.numpy().copy()
    inv_w = rng.uniform(0, 1, (T, K)).astype(np.float32)
    if layout == "all_sentinel":
        tok[:] = T
    elif layout == "all_dropped":
        inv_idx[:] = S
    else:
        inv_w[inv_idx == S] = 0.0
        assert (tok == T).mean() > 0.6 and (inv_idx == S).any()
    y = rng.standard_normal((S, d)).astype(np.float32)
    g_perm = rng.standard_normal((S, d)).astype(np.float32)
    g_un = rng.standard_normal((T, d)).astype(np.float32)
    return x, tok, y, inv_idx, inv_w, g_perm, g_un


def case_for(layout, K=2):
    """A seed: ``permute_case``'s random indices; a name: ``layout_2x2``."""
    if isinstance(layout, int):
        return permute_case(layout, K=K), TOL
    return layout_2x2(layout), TOL_2X2


def assert_at_most_adds(idx, n, k):
    """No row of a discard-row backward's buffer takes more than ``k``
    adds from the scatters over ``idx`` (all columns together)."""
    rows = torch.cat([permute_ops._discard_rows(c, n)
                      for c in t(idx).reshape(t(idx).shape[0], -1).T])
    assert int(torch.bincount(rows).max()) <= k


@pytest.mark.parametrize("seed", [0, 1, "route_2x2", "all_sentinel"])
def test_permute_matches_jax_kernel_fwd_and_vjp(seed):
    (x, tok, _, _, _, g, _), tol = case_for(seed)
    jy, vjp = jax.vjp(lambda a: jpermute_ops.permute(
        a, jnp.asarray(tok), use_pallas=True), jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    for fwd in ("plain", "function"):
        xt = t(x).requires_grad_(True)
        if fwd == "plain":
            y = permute_ops.permute(xt, t(tok))
        else:
            y = permute_ops.Permute.apply(xt, t(tok), permute_ref)
        y.backward(t(g))
        close(y, jy, **tol)
        close(xt.grad, jgx, **tol)
    if not isinstance(seed, int):
        # each sentinel slot into its own discard row; a routed token holds
        # at most top-k (2) slots
        assert_at_most_adds(tok, x.shape[0], 2)


@pytest.mark.parametrize("seed", [0, 1, "route_2x2", "all_dropped"])
def test_unpermute_matches_jax_kernel_fwd_and_vjp(seed):
    (_, _, y, inv_idx, inv_w, _, g), tol = case_for(seed, K=3)
    jout, vjp = jax.vjp(lambda a, w: jpermute_ops.unpermute(
        a, jnp.asarray(inv_idx), w, use_pallas=True), jnp.asarray(y),
        jnp.asarray(inv_w))
    jgy, jgw = vjp(jnp.asarray(g))
    for fwd in ("plain", "function"):
        yt = t(y).requires_grad_(True)
        wt = t(inv_w).requires_grad_(True)
        if fwd == "plain":
            out = permute_ops.unpermute(yt, t(inv_idx), wt)
        else:
            out = permute_ops.Unpermute.apply(yt, t(inv_idx), wt,
                                              unpermute_ref)
        out.backward(t(g))
        close(out, jout, **tol)
        close(yt.grad, jgy, **tol)
        close(wt.grad, jgw, **tol)
    if not isinstance(seed, int):
        # a slot is one (token, pick); a dropped pick's discard row is its
        # token's, which takes at most K adds
        assert_at_most_adds(inv_idx, y.shape[0], inv_idx.shape[1])


# ---------------------------------------------------------------------------
# K3: ragged grouped FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("layout", ["stage_segments", "equal"])
def test_ragged_ffn_matches_jax_kernel_fwd_and_vjp(activation, layout):
    rng = np.random.default_rng(3)
    E, d, f = 3, 32, 64
    if layout == "equal":
        offs, exps = transport.expert_segments(E, 8), tuple(range(E))
    else:      # the 2x2 plan's shape: per expert 2 wide + 4 narrow segments
        offs, exps = transport.stage_segments(E, ((2, 6), (4, 2)))
    R = offs[-1]
    x = rng.standard_normal((R, d)).astype(np.float32)
    widths = np.diff(offs)
    valid = np.array([rng.integers(0, w + 1) for w in widths], np.int32)
    valid[0] = widths[0]
    wi, wg, wo = ((rng.standard_normal(s) * 0.3).astype(np.float32)
                  for s in ((E, d, f), (E, d, f), (E, f, d)))
    wg = wg if activation == "swiglu" else None
    g = rng.standard_normal((R, d)).astype(np.float32)

    def jfn(x_, wi_, wo_, wg_):
        return jgemm_ops.grouped_ffn_ragged(
            x_, offs, exps, jnp.asarray(valid), wi_, wg_, wo_,
            activation=activation, use_pallas=True)
    jargs = [jnp.asarray(a) for a in (x, wi, wo)] + \
        ([jnp.asarray(wg)] if wg is not None else [None])
    jy, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(g))

    for fwd in ("plain", "function"):
        ts = [t(a).requires_grad_(True) for a in (x, wi, wo)]
        wgt = t(wg).requires_grad_(True) if wg is not None else None
        if fwd == "plain":
            y = gemm_ops.grouped_ffn_ragged(ts[0], offs, exps, t(valid), ts[1],
                                            wgt, ts[2],
                                            activation=activation)
        else:
            y = gemm_ops.GroupedFFNRagged.apply(
                ts[0], t(valid), ts[1], wgt, ts[2],
                (offs, exps, activation),
                lambda static, *a: grouped_ffn_ragged_ref(
                    a[0], static[0], static[1], a[1], a[2], a[3], a[4],
                    activation=static[2]))
        y.backward(t(g))
        close(y, jy)
        for got, want in zip(ts + ([wgt] if wgt is not None else []),
                             jgrads):
            close(got.grad, want)
    # rows at or past rows_valid are exact zeros
    rows = np.arange(R)
    seg = np.searchsorted(np.asarray(offs)[1:], rows, side="right")
    dead = rows - np.asarray(offs)[seg] >= valid[seg]
    assert (np.asarray(y.detach())[dead] == 0).all()


def test_segments_entry_and_unported_branches():
    rng = np.random.default_rng(4)
    E, d, f, C = 2, 16, 32, 4
    x = t(rng.standard_normal((E * C, d)).astype(np.float32))
    wi, wo = (t((rng.standard_normal(s) * 0.3).astype(np.float32))
              for s in ((E, d, f), (E, f, d)))
    offs = transport.expert_segments(E, C)
    dense = gemm_ops.grouped_ffn_segments(x, offs, wi, None, wo,
                                          activation="gelu", use_pallas=False)
    ragged = gemm_ops.grouped_ffn_segments(x, offs, wi, None, wo,
                                           activation="gelu", use_pallas=True)
    close(dense, ragged)
    # quantized=True takes the int8 entry (K7's plain version on the CPU)
    quant = gemm_ops.grouped_ffn_segments(x, offs, wi, None, wo,
                                          activation="gelu", quantized=True)
    equal(quant, grouped_ffn_ragged_quant_ref(x, offs, tuple(range(E)), None,
                                              wi, None, wo,
                                              activation="gelu"))
    # MoEConfig(use_kernel=True) (K6's dense entry, its plain version on
    # the CPU) through expert_ffn_flat, against the JAX package's
    kw = dict(d_model=d, d_ff=f, num_experts=E, top_k=1, activation="gelu",
              use_kernel=True)
    cfg = base.MoEConfig(dtype=torch.float32, **kw)
    jcfg = jdispatch.MoEConfig(dtype=jnp.float32, **kw)
    ep = base.EPSpec.from_axes(("data",), (1,))
    jep = jdispatch.EPSpec.from_axes(("data",), (1,))
    got = base.expert_ffn_flat({"w_in": wi, "w_out": wo}, x, offs, cfg, ep)
    want = jdispatch.expert_ffn_flat(
        {"w_in": jnp.asarray(wi.numpy()), "w_out": jnp.asarray(wo.numpy())},
        jnp.asarray(x.numpy()), offs, jcfg, jep)
    close(got, want)
    close(got, dense)
