"""Parity of the port's kernel entries (plain versions, on the CPU) with the
JAX package's kernels and references.

- K4 ``moe_fused.local_moe`` against JAX's ``local_moe_ref`` and against
  JAX's ``local_moe(..., use_pallas=True)``, which runs the Pallas kernel
  under the interpreter on the CPU (as ``tests/test_moe_fused.py`` does),
  on the gather path's slot layouts at 0/50/100% occupancy with garbage
  tokens and weights parked past ``rows_valid``.
- K4's compaction (``ref.compact_slots``, what the CUDA kernel's first
  launch computes): a stable partition of each segment's counted slots
  (a hypothesis property), and ``local_moe_ref`` over the compacted
  layout equal to both JAX versions over the dense one, on the gather
  layouts, a sentinel prefill layout and a one-rank ``local_layout`` of a
  real route.  K4's token index (``ref.token_rows``, what its scan, fill
  and the combine's sort build): each live slot once under its token in
  ascending tile rows (a hypothesis property), and the combine's sum in
  that order equal to ``local_moe_ref`` on those layouts.  K4's and K3's
  tile tables, and the build's hash of the headers a source includes.
- K5 ``flash_attn.flash_attention`` against ``flash_attention_pallas(...,
  interpret=True)`` and ``layers._sdpa``: causal, windowed, GQA, and an Sq
  that is not a multiple of the block.
- The argument checks of K5's and K8's CUDA entries: head dims 64 and 128
  reach the launch (a stub here), any other is refused by name.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
Inputs are made by numpy from a seed; tolerance rtol = atol = 1e-4 in
float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - exercised only without hypothesis
    from _hypothesis_fallback import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.moe_fused import ops as jfused_ops
from repro.kernels.moe_fused.ref import local_moe_ref as jlocal_moe_ref
from repro.kernels.moe_gemm import ops as jgemm_ops
from repro.models import layers as jlayers
from repro_torch.core import capacity, gating
from repro_torch.core.dispatch import base, engine, routing, transport
from repro_torch.kernels import backend
from repro_torch.kernels.decode_attn import ops as dec_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.moe_fused import ops as fused_ops
from repro_torch.kernels.moe_fused import ref as fused_ref
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.kernels.moe_gemm import ref as gemm_ref
from repro_torch.kernels.moe_permute import ref as permute_ref

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def gather_layout(rng, Tg, E, occupancy, garbage=True):
    """The gather path's dense [E, Tg] slot grid (slot ``e * Tg + t`` maps
    token ``t`` through expert ``e``) with ``occupancy`` of each segment
    valid; slack slots hold real tokens with nonzero weights when
    ``garbage`` is set, which both sides must ignore."""
    tok = np.tile(np.arange(Tg, dtype=np.int32), E)
    w = rng.uniform(0.1, 1.0, E * Tg).astype(np.float32)
    nv = int(round(Tg * occupancy))
    valid = np.full(E, nv, np.int32)
    valid[1] = Tg if occupancy > 0 else 0     # one full, if any is live
    for e in range(E):
        lo, hi = e * Tg + valid[e], (e + 1) * Tg
        if garbage:
            tok[lo:hi] = rng.integers(0, Tg, hi - lo)
        else:
            tok[lo:hi], w[lo:hi] = Tg, 0.0
    w[rng.random(E * Tg) < 0.3] = 0.0          # tokens that skip an expert
    return tok, w, valid


def weights(rng, E, d, f):
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in ((E, d, f), (E, d, f), (E, f, d))]


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("occupancy", [0.0, 0.5, 1.0])
def test_local_moe_matches_jax(occupancy, activation):
    rng = np.random.default_rng(0)
    Tg, E, d, f = 8, 4, 64, 128
    x = rng.standard_normal((Tg, d)).astype(np.float32)
    tok, w, valid = gather_layout(rng, Tg, E, occupancy)
    wi, wg, wo = weights(rng, E, d, f)
    offs = transport.expert_segments(E, Tg)
    exps = tuple(range(E))
    wg = wg if activation == "swiglu" else None
    got = fused_ops.local_moe(
        torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(w),
        offs, exps, torch.from_numpy(valid), torch.from_numpy(wi),
        None if wg is None else torch.from_numpy(wg), torch.from_numpy(wo),
        activation=activation)
    jargs = (jnp.asarray(x), jnp.asarray(tok), jnp.asarray(w), offs, exps,
             jnp.asarray(valid), jnp.asarray(wi),
             None if wg is None else jnp.asarray(wg), jnp.asarray(wo))
    close(got, jlocal_moe_ref(*jargs, activation=activation))
    close(got, jfused_ops.local_moe(*jargs, activation=activation,
                                    use_pallas=True))
    if occupancy == 0.0:
        assert not np.asarray(got).any()


def test_local_moe_prefill_layout_sentinel_slots():
    """A ragged prefill-like layout (unequal segments, sentinel slots)."""
    rng = np.random.default_rng(1)
    T, E, d, f = 12, 3, 64, 64
    offs = (0, 16, 24, 40)
    exps = (2, 0, 1)
    S = offs[-1]
    tok = rng.integers(0, T + 1, S).astype(np.int32)      # T = sentinel
    w = np.where(tok == T, 0.0, rng.uniform(0.1, 1.0, S)).astype(np.float32)
    valid = np.asarray([16, 5, 0], np.int32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    wi, _, wo = weights(rng, E, d, f)
    got = fused_ops.local_moe(
        torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(w),
        offs, exps, torch.from_numpy(valid), torch.from_numpy(wi), None,
        torch.from_numpy(wo), activation="gelu")
    want = jlocal_moe_ref(jnp.asarray(x), jnp.asarray(tok), jnp.asarray(w),
                          offs, exps, jnp.asarray(valid), jnp.asarray(wi),
                          None, jnp.asarray(wo), activation="gelu")
    close(got, want)


@pytest.mark.parametrize("offs,exps", [((0, 8, 16, 24, 32), (0, 1, 2, 3)),
                                       ((0, 100, 230, 236), (1, 0, 1)),
                                       ((0, 512, 1024), (0, 1))])
def test_block_planning(offs, exps):
    """plan_blocks is the reference's; plan_tiles (the CUDA kernel's fixed
    64-row tiling) covers every slot exactly once, inside one segment."""
    for got, want in zip(gemm_ops.plan_blocks(offs, exps),
                         jgemm_ops.plan_blocks(offs, exps)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    tiles = fused_ops.plan_tiles(offs, exps)
    seen = np.zeros(offs[-1], np.int32)
    for first, e, s, loc, rows in tiles:
        assert 0 < rows <= fused_ops.TILE_ROWS and e == exps[s]
        assert offs[s] + loc == first and loc + rows <= offs[s + 1] - offs[s]
        seen[first:first + rows] += 1
    assert (seen == 1).all()


def test_permute_refs_match_jax():
    from repro.kernels.moe_permute import ref as jref
    rng = np.random.default_rng(2)
    T, S, K, d = 10, 14, 2, 16
    x = rng.standard_normal((T, d)).astype(np.float32)
    tok = rng.integers(0, T + 1, S).astype(np.int32)
    y = rng.standard_normal((S, d)).astype(np.float32)
    inv_idx = rng.integers(0, S + 1, (T, K)).astype(np.int32)
    inv_w = rng.uniform(0, 1, (T, K)).astype(np.float32)
    close(permute_ref.permute_ref(torch.from_numpy(x), torch.from_numpy(tok)),
          jref.permute_ref(jnp.asarray(x), jnp.asarray(tok)))
    close(permute_ref.unpermute_ref(torch.from_numpy(y),
                                    torch.from_numpy(inv_idx),
                                    torch.from_numpy(inv_w)),
          jref.unpermute_ref(jnp.asarray(y), jnp.asarray(inv_idx),
                             jnp.asarray(inv_w)))


@pytest.mark.parametrize("B,Sq,H,K,hd,causal,window", [
    (2, 64, 4, 2, 32, True, 0),        # causal GQA
    (1, 72, 4, 4, 64, True, 24),       # windowed; 72 is not a block multiple
    (1, 40, 2, 1, 32, False, 0),       # bidirectional
])
def test_flash_attention_matches_jax(B, Sq, H, K, hd, causal, window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 sliding_window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = flash_attention_pallas(jq, jk, jv, causal=causal,
                                  sliding_window=window, block_q=32,
                                  block_k=32, interpret=True)
    pos = jnp.arange(Sq)
    sdpa = jlayers._sdpa(jq, jk, jv, causal=causal, sliding_window=window,
                         q_positions=pos, k_positions=pos)
    close(got, kern)
    close(got, sdpa)


def test_cpu_tensors_take_the_plain_versions():
    """Even with kernels forced on, CPU tensors run the plain versions and
    no kernel launch is counted."""
    backend.reset_launches()
    x = torch.randn(4, 64)
    out = fused_ops.local_moe(
        x, torch.arange(8, dtype=torch.int32) % 4, torch.ones(8),
        (0, 4, 8), (0, 1), None, torch.randn(2, 64, 64), None,
        torch.randn(2, 64, 64), activation="gelu", use_pallas=True)
    q = torch.randn(1, 8, 2, 32)
    fa_ops.flash_attention(q, q, q, use_pallas=True)
    assert out.shape == (4, 64) and out.dtype == torch.float32
    assert all(n == 0 for n in backend.LAUNCHES.values())


@pytest.mark.parametrize("hd", [64, 128, 96, 256])
def test_attention_entries_take_head_dims_64_and_128_only(monkeypatch, hd):
    """K5's and K8's CUDA entries (``_flash_cuda``, ``_decode_cuda``) with
    the built library stubbed: bf16 q/k/v of head dim 64 or 128 reach the
    launch with that ``hd`` and any other dtype is refused; any other head
    dim raises, naming the head dims built, before any launch (nothing
    here reaches nvcc)."""
    calls = []

    def stub(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fa_ops, "_entry", lambda: stub)
    monkeypatch.setattr(dec_ops, "_entry", lambda: (stub, 512))
    monkeypatch.setattr(backend, "stream_ptr", lambda device: 0)
    for name in (fa_ops.KERNEL, dec_ops.KERNEL):
        monkeypatch.setitem(backend.LAUNCHES, name, 0)
    bf = torch.bfloat16
    q = torch.zeros((1, 8, 4, hd), dtype=bf)
    kv = torch.zeros((1, 8, 2, hd), dtype=bf)
    qd = torch.zeros((2, 4, hd), dtype=bf)
    kvd = torch.zeros((2, 16, 2, hd), dtype=bf)
    lens = torch.tensor([3, 16], dtype=torch.int32)
    with torch.no_grad():
        if hd in (64, 128):
            assert fa_ops._flash_cuda(q, kv, kv, True, 0).shape == q.shape
            assert dec_ops._decode_cuda(qd, kvd, kvd, lens, 0).shape == \
                qd.shape
            # hd is the tenth argument of flash_attention_fwd and the
            # twelfth of decode_attention_fwd
            assert [c[9] for c in calls[:1]] + [c[11] for c in calls[1:]] \
                == [hd, hd]
            assert backend.LAUNCHES[fa_ops.KERNEL] == 1
            assert backend.LAUNCHES[dec_ops.KERNEL] == 1
            with pytest.raises(TypeError, match="bfloat16"):
                fa_ops._flash_cuda(q.float(), kv.float(), kv.float(), True,
                                   0)
            with pytest.raises(TypeError, match="bfloat16"):
                dec_ops._decode_cuda(qd.float(), kvd.float(), kvd.float(),
                                     lens, 0)
            assert len(calls) == 2
        else:
            with pytest.raises(ValueError, match=rf"head_dim {hd}.*"
                               r"head dims \(64, 128\)"):
                fa_ops._flash_cuda(q, kv, kv, True, 0)
            with pytest.raises(ValueError, match=rf"head_dim {hd}.*"
                               r"head dims \(64, 128\)"):
                dec_ops._decode_cuda(qd, kvd, kvd, lens, 0)
            assert calls == []


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), n_seg=st.integers(1, 6),
       T=st.integers(1, 12))
def test_compact_slots_is_a_stable_partition(seed, n_seg, T):
    """Every counted slot with a weight and a token in [0, T) appears once,
    in order, at the front of its own segment's range; -1 after them;
    counts at most the clamped ``rows_valid``."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 20, n_seg)
    offs = (0,) + tuple(int(o) for o in np.cumsum(widths))
    S = offs[-1]
    tok = rng.integers(-1, T + 2, S).astype(np.int32)   # T: the sentinel
    w = rng.uniform(0.1, 1.0, S).astype(np.float32)
    w[rng.random(S) < 0.3] = 0.0
    w[rng.random(S) < 0.1] = -0.0
    valid = rng.integers(-2, widths + 3).astype(np.int32)
    live, count = fused_ref.compact_slots(
        torch.from_numpy(tok), torch.from_numpy(w), offs,
        torch.from_numpy(valid), T)
    assert live.dtype == torch.int32 and count.dtype == torch.int32
    live, count = live.numpy(), count.numpy()
    for s in range(n_seg):
        lo, hi = offs[s], offs[s + 1]
        n = min(max(int(valid[s]), 0), hi - lo)
        want = [i for i in range(lo, lo + n)
                if w[i] != 0 and 0 <= tok[i] < T]
        assert count[s] == len(want) <= max(int(valid[s]), 0)
        assert live[lo:lo + len(want)].tolist() == want
        assert (live[lo + len(want):hi] == -1).all()
    kept = live[live >= 0]
    assert len(set(kept.tolist())) == len(kept) == count.sum()


def compacted(tok, w, offs, valid, T):
    """The compacted layout of ``ref.compact_slots``: the live slots'
    tokens and weights at the front of each segment, sentinels after, the
    counts as ``rows_valid``."""
    live, count = fused_ref.compact_slots(tok, w, offs, valid, T)
    keep = live >= 0
    ctok = torch.full_like(tok, T)
    cw = torch.zeros_like(w)
    ctok[keep] = tok[live[keep].long()]
    cw[keep] = w[live[keep].long()]
    return ctok, cw, count


def one_rank_layout(rng, T, E, K, d):
    """A one-rank ``local_layout`` of a real ``route`` (unit world, caps
    from the Eq. 7 plan): E segments as wide as the capacity, partly
    filled, sentinel slots past each expert's rows."""
    plan = capacity.make_dispatch_plan(
        tokens_per_device=T, num_experts=E, top_k=K, capacity_factor=1.25,
        axis_sizes=(1,), mode="ta")
    ep = base.EPSpec.from_axes(("data",), (1,))
    cfg = base.MoEConfig(d_model=d, d_ff=2 * d, num_experts=E, top_k=K,
                         dtype=torch.float32)
    gate = gating.GateConfig(num_experts=E, top_k=K, aux_mode="ta",
                             penalty_by_level=(0.0, 0.0, 0.0))
    x = rng.standard_normal((T, d)).astype(np.float32)
    gw = rng.standard_normal((d, E)).astype(np.float32)
    routed = routing.route({"gate": {"w": torch.from_numpy(gw)}},
                           torch.from_numpy(x), cfg, ep, plan, gate,
                           coords=(0,))
    stages = transport.plan_stages(plan, ep)
    local = [(stage, sel) for (_, sel), stage in zip(routed.sels, stages)]
    li, offs, exps = engine.local_layout(
        local, routed.gate_out["topk_idx"], T, E)
    return (x, li.slot_to_token.numpy(), li.slot_w.numpy(), offs, exps,
            li.rows_per_expert.numpy())


def k4_layout(name, rng):
    """``(x, tok, w, offs, exps, valid)`` of one K4 test layout."""
    Tg, E, d = 8, 4, 64
    if name.startswith("gather"):
        tok, w, valid = gather_layout(rng, Tg, E, float(name.split("_")[1]))
        x = rng.standard_normal((Tg, d)).astype(np.float32)
        return x, tok, w, transport.expert_segments(E, Tg), tuple(range(E)), \
            valid
    if name == "prefill_sentinels":
        T, offs, exps = 12, (0, 16, 24, 40), (2, 0, 1)
        tok = rng.integers(0, T + 1, offs[-1]).astype(np.int32)
        w = rng.uniform(0.1, 1.0, offs[-1]).astype(np.float32)
        w[rng.random(offs[-1]) < 0.2] = 0.0
        w[rng.random(offs[-1]) < 0.1] = 0.5     # some weighted sentinels
        valid = np.asarray([16, 5, 0], np.int32)
        x = rng.standard_normal((T, d)).astype(np.float32)
        return x, tok, w, offs, exps, valid
    return one_rank_layout(rng, 32, E, 2, d)


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("layout", ["gather_0.0", "gather_0.5",
                                    "gather_1.0", "prefill_sentinels",
                                    "one_rank"])
def test_local_moe_over_compacted_layout_matches_jax(layout, activation):
    """What K4 computes on the card (the FFN over the compacted live slots
    only) equals both JAX versions over the dense layout."""
    rng = np.random.default_rng(5)
    x, tok, w, offs, exps, valid = k4_layout(layout, rng)
    T, d = x.shape
    E = max(exps) + 1
    wi, wg, wo = weights(rng, E, d, 128)
    wg = wg if activation == "swiglu" else None
    ctok, cw, count = compacted(torch.from_numpy(tok), torch.from_numpy(w),
                                offs, torch.from_numpy(valid), T)
    assert int(count.sum()) <= int(np.minimum(
        np.maximum(valid, 0), np.diff(offs)).sum())
    got = fused_ref.local_moe_ref(
        torch.from_numpy(x), ctok, cw, offs, exps, count,
        torch.from_numpy(wi), None if wg is None else torch.from_numpy(wg),
        torch.from_numpy(wo), activation=activation)
    jargs = (jnp.asarray(x), jnp.asarray(tok), jnp.asarray(w), offs, exps,
             jnp.asarray(valid), jnp.asarray(wi),
             None if wg is None else jnp.asarray(wg), jnp.asarray(wo))
    close(got, jlocal_moe_ref(*jargs, activation=activation))
    close(got, jfused_ops.local_moe(*jargs, activation=activation,
                                    use_pallas=True))


def test_compact_slots_entry_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(6)
    x, tok, w, offs, exps, valid = k4_layout("one_rank", rng)
    args = (torch.from_numpy(tok), torch.from_numpy(w), offs,
            torch.from_numpy(valid), x.shape[0])
    backend.reset_launches()
    live, count = fused_ops.compact_slots(*args, use_pallas=True)
    want_live, want_count = fused_ref.compact_slots(*args)
    assert torch.equal(live, want_live) and torch.equal(count, want_count)
    assert int(count.sum()) == int((torch.from_numpy(w) != 0).sum())
    assert all(n == 0 for n in backend.LAUNCHES.values())


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), n_seg=st.integers(1, 6),
       T=st.integers(1, 12))
def test_token_rows_lists_each_live_slot_once_ascending(seed, n_seg, T):
    """Each token's list holds the tile rows of its live slots (counted,
    weighted, token in [0, T)) once each, ascending: segment ``s``'s
    ``j``-th live slot at row 64 x (its first tile) + j of the tile table;
    the counts are the live slots' bincount; sentinel, negative and
    past-``rows_valid`` slots are absent."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 150, n_seg)
    offs = (0,) + tuple(int(o) for o in np.cumsum(widths))
    S = offs[-1]
    tok = rng.integers(-1, T + 2, S).astype(np.int32)   # T: the sentinel
    w = rng.uniform(0.1, 1.0, S).astype(np.float32)
    w[rng.random(S) < 0.3] = 0.0
    valid = rng.integers(-2, widths + 3).astype(np.int32)
    row_ptr, rows = fused_ref.token_rows(
        torch.from_numpy(tok), torch.from_numpy(w), offs,
        torch.from_numpy(valid), T)
    assert row_ptr.dtype == torch.int32 and rows.dtype == torch.int32
    tiles = fused_ops.plan_tiles(offs, tuple(range(n_seg)))
    want = {t: [] for t in range(T)}
    for s in range(n_seg):
        first_tile = int(np.searchsorted(tiles[:, 2], s))
        n = min(max(int(valid[s]), 0), int(widths[s]))
        live = [i for i in range(offs[s], offs[s] + n)
                if w[i] != 0 and 0 <= tok[i] < T]
        for j, i in enumerate(live):
            want[int(tok[i])].append(fused_ops.TILE_ROWS * first_tile + j)
    counts = [len(want[t]) for t in range(T)]
    assert np.diff(row_ptr.numpy()).tolist() == counts
    assert row_ptr[0] == 0 and int(row_ptr[-1]) == rows.numel()
    for t in range(T):
        mine = rows[row_ptr[t]:row_ptr[t + 1]].tolist()
        assert mine == want[t] == sorted(set(mine))


def ordered_combine(x, tok, w, offs, exps, valid, wi, wg, wo, activation):
    """What K4's combine computes, written with the plain token index:
    each slot's f32 row of the FFN over the compacted layout, then for each
    token, from 0, += slot_w * row over its list in ascending order."""
    T = x.shape[0]
    live, count = fused_ref.compact_slots(tok, w, offs, valid, T)
    keep = live >= 0
    slots = live[keep].long()
    starts = fused_ref.tile_starts(offs)
    offs_t = torch.as_tensor(offs)
    pos = torch.nonzero(keep).flatten()
    seg = torch.searchsorted(offs_t[1:], pos, right=True)
    slot_of = dict(zip((starts[seg] + pos - offs_t[seg]).tolist(),
                       slots.tolist()))
    ctok = torch.full_like(tok, T)
    ctok[keep] = tok[slots]
    ys = gemm_ref.grouped_ffn_ragged_ref(
        permute_ref.permute_ref(x, ctok), offs, exps, count, wi, wg, wo,
        activation=activation)
    where = torch.full((tok.shape[0],), -1, dtype=torch.int64)
    where[slots] = pos
    row_ptr, rows = fused_ref.token_rows(tok, w, offs, valid, T)
    out = torch.zeros((T, x.shape[1]), dtype=torch.float32)
    for t in range(T):
        for r in rows[row_ptr[t]:row_ptr[t + 1]].tolist():
            s = slot_of[r]
            out[t] += w[s] * ys[where[s]].to(torch.float32)
    return out


@pytest.mark.parametrize("layout", ["gather_0.0", "gather_0.5",
                                    "gather_1.0", "prefill_sentinels",
                                    "one_rank"])
def test_ordered_combine_over_token_rows_matches_local_moe_ref(layout):
    """The combine's order (each token's rows ascending, each row's weighted
    f32 output added from 0) gives ``ref.local_moe_ref``'s output at 1e-6
    on the compacted layouts."""
    rng = np.random.default_rng(7)
    x, tok, w, offs, exps, valid = k4_layout(layout, rng)
    E = max(exps) + 1
    wi, _, wo = (torch.from_numpy(a) for a in weights(rng, E, x.shape[1],
                                                      128))
    args = (torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(w),
            offs, exps, torch.from_numpy(valid))
    got = ordered_combine(*args, wi, None, wo, "gelu")
    want = fused_ref.local_moe_ref(*args, wi, None, wo, activation="gelu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_token_rows_entry_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(8)
    x, tok, w, offs, exps, valid = k4_layout("one_rank", rng)
    args = (torch.from_numpy(tok), torch.from_numpy(w), offs)
    backend.reset_launches()
    row_ptr, rows = fused_ops.token_rows(*args, exps,
                                         torch.from_numpy(valid),
                                         x.shape[0], use_pallas=True)
    want_ptr, want_rows = fused_ref.token_rows(*args,
                                               torch.from_numpy(valid),
                                               x.shape[0])
    assert torch.equal(row_ptr, want_ptr) and torch.equal(rows, want_rows)
    assert int(row_ptr[-1]) == int((torch.from_numpy(w) != 0).sum())
    assert all(n == 0 for n in backend.LAUNCHES.values())


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("exps,widths", [
    ((0, 1, 2, 3), (5, 6, 0, 7)),                  # one segment an expert
    ((0, 1, 2, 3, 0, 1, 2, 3), (3, 2, 4, 1, 2, 2, 3, 5)),   # staged
])
def test_k4_backward_by_expert_groups_matches_autograd(activation, exps,
                                                       widths):
    """K4's backward taken one group of experts at a time
    (``segment_groups`` under a budget of one, then two experts' float32
    weights) gives autograd's gradients through ``local_moe_ref`` for the
    input, the combine weights and every expert weight (float32, 1e-6);
    an expert whose segments fall in two groups gets both groups'
    parts."""
    T, d, f = 20, 16, 32
    gen = torch.Generator().manual_seed(4)
    offs = tuple(int(o) for o in np.cumsum((0,) + widths))
    S, E = offs[-1], max(exps) + 1
    tok = torch.randint(0, T + 1, (S,), generator=gen, dtype=torch.int32)
    w = torch.rand(S, generator=gen) * (tok != T)
    valid = torch.tensor([max(0, n - 1) for n in widths], dtype=torch.int32)
    inputs = [torch.randn(s, generator=gen) * 0.3 for s in
              ((T, d), (E, d, f), (E, d, f), (E, f, d))]
    if activation == "gelu":
        inputs[2] = None
    g = torch.randn((T, d), generator=gen)
    mats = 3 if activation == "swiglu" else 2
    one = 4 * mats * d * f

    def grads(run):
        x, wi, wg, wo = (None if t is None else t.clone().requires_grad_(True)
                         for t in inputs)
        sw = w.clone().requires_grad_(True)
        (run(x, sw, wi, wg, wo) * g).sum().backward()
        return [t.grad for t in (x, sw, wi, wg, wo) if t is not None]

    want = grads(lambda x, sw, wi, wg, wo: fused_ref.local_moe_ref(
        x, tok, sw, offs, exps, valid, wi, wg, wo, activation=activation))
    for budget in (one, 2 * one):
        assert len(fused_ops.segment_groups(exps, one, budget)) > 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fused_ops, "BACKWARD_GROUP_BYTES", budget)
            got = grads(lambda x, sw, wi, wg, wo: fused_ops.LocalMoE.apply(
                x, tok, sw, valid, wi, wg, wo, (offs, exps, activation),
                lambda st, *t: fused_ref.local_moe_ref(
                    t[0], t[1], t[2], st[0], st[1], t[3], t[4], t[5], t[6],
                    activation=st[2])))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_k4_layouts_write_disjoint_without_atomics():
    """K4's registered layouts: the source's six launches in order, no
    declared atomic accumulation, and no two blocks of a launch writing
    one element (the scatter-race rule)."""
    from repro_torch.analysis import launch_check
    lays = backend.registered_layouts()[fused_ops.KERNEL]
    # 6; 3 at gpt3's tensor-parallel f / 2; 3 of DeepSeek-V2-Lite's and
    # Jamba's experts at theirs; 6 of theirs and DeepSeek-V2-236B's on the
    # 2x2 EP world; Jamba's one-rank training layout
    assert len(lays) == 19
    for lay in lays:
        assert [ln.kernel.split("<")[0] for ln in lay.launches] == [
            "compact_kernel", "scan_kernel", "fill_kernel", "fused_up_kernel",
            "fused_down_kernel", "combine_kernel"]
        assert "acc_guarded" not in lay.meta
        assert launch_check.check_scatter_race(lay) == []
        T = lay.meta["geometry"][2][2]
        assert lay.launches[-1].grid == (T, 1, 1)


@pytest.mark.parametrize("H,K,hd,heads", [
    (16, 16, 64, 4),           # gpt3_medium_moe's heads
    (16, 8, 128, 4),           # the dense decoders' 8 KV heads of 128
    (24, 8, 128, 4),           # G = 3
    (16, 1, 128, 16),          # G = 16: state for 16 heads a warp
    (32, 2, 64, 16),
])
def test_k8_split_launch_picks_its_instantiation(H, K, hd, heads):
    assert dec_ops.state_heads(H // K) == heads
    split, combine = dec_ops.decode_launches(32, 32768, H, K, hd)
    assert split.kernel == f"decode_split_kernel<{hd},{heads}>"
    assert split.grid == (K, 32768 // dec_ops.SPLIT_ROWS, 32)
    assert split.static_smem == 4 * heads * hd
    assert combine.grid == (32 * H, 1, 1) and combine.threads == hd


@pytest.mark.parametrize("E,width,f,splits", [
    (64, 8, 2048, 4),         # the decode layout
    (64, 8, 128, 2),          # f = 128 takes two 64-deep halves at most
    (64, 512, 2048, 1),       # the prefill pack
    (64, 128, 2048, 1),       # the one-rank training layout
    (3, 100, 2048, 1),        # a segment of 100: tiles of 64 and 36 rows
])
def test_k4_layout_tables(E, width, f, splits):
    offs = transport.expert_segments(E, width)
    exps = tuple(range(E))
    assert fused_ops.down_splits(offs, f) == splits
    offs_dev, tiles, tile0, got = fused_ops.layout_on(offs, exps, f, "cpu")
    assert got == splits
    assert offs_dev.dtype == torch.int32 and offs_dev.tolist() == list(offs)
    assert tiles.shape[0] == E * -(-width // fused_ops.TILE_ROWS)
    for s in range(E):                 # each segment's first tile
        first = tiles[int(tile0[s])]
        assert int(first[2]) == s and int(first[3]) == 0
    assert fused_ops.layout_on(offs, exps, f, "cpu")[1] is tiles


def test_k3_tiles_by_expert_span_at_the_2x2_layout():
    """K3 at the 2x2 plan's rank-0 buffer (caps (120, 16), S = 4864): 5
    span tiles an expert (4 x 64 + 48 rows), 80 in all, where the segment
    tiling gave 8 an expert and 128."""
    segs, exps = transport.stage_segments(16, ((2, 120), (4, 16)))
    assert segs[-1] == 4864
    span = fused_ops.plan_expert_tiles(segs, exps)
    assert np.bincount(span[:, 1], minlength=16).tolist() == [5] * 16
    assert sorted(set(span[:, 2].tolist())) == [48, 64]
    assert len(span) == 80 and len(fused_ops.plan_tiles(segs, exps)) == 128


def test_lib_path_hashes_the_headers_a_source_includes(tmp_path,
                                                       monkeypatch):
    """Editing a header that a source includes (directly or through
    another header) changes the source's library name, so no stale build
    is loaded; the port's K3 and K4 sources include the shared one."""
    assert backend.CSRC_DIR / "moe_mma.cuh" in backend._sources_of(
        "moe_fused")
    assert backend.CSRC_DIR / "moe_mma.cuh" in backend._sources_of(
        "moe_gemm")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(backend, "CSRC_DIR", tmp_path)
    before = backend._lib_path("k")
    assert backend._lib_path("k") == before
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert backend._lib_path("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert backend._lib_path("k") != before
