#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  — requires ``torch.cuda.is_available()`` (otherwise exits
   non-zero before printing any result) and prints the card's name and
   power limit as ``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader`` gives them;
2. build   — compiles every CUDA source under ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together);
3. checks  — holds each kernel against its plain PyTorch version on the
   card in bf16 at the full-width shapes its main path gives it: the
   fused local-MoE kernel (K4) at the decode layout (8 slots x 64
   experts), the prefill layout (4 x 128 tokens x 64 experts) and the
   one-rank training layout (a real route of 2048 tokens, 64 segments of
   128 slots, partly filled), flash attention (K5) at the prefill shape
   [4, 128, 16, 64] (plus ragged and windowed edge shapes), permute
   (K1) and unpermute (K2) on rank (0, 0)'s indices of the 2x2 training
   plan and of chunk 0 of the pipelined int8 plan (S = 4864 and 608 slots;
   plus edge cases: other element types and row widths, S = 0, all
   sentinels, dropped picks, K = 1, 4 and 40, uneven grids, refused
   rows), each also read as ``device_ms`` (the card's time only),
   ``call_ms`` (called as the training path calls it, under grad) and
   ``host_us`` (the enqueue cost) beside its library call, by
   ``chip_ab.py``'s reading functions, the ragged
   grouped FFN (K3) on rank (0, 0)'s indices of the 2x2 training plan
   (1024 tokens, caps (120, 16), 16 experts a rank), and the int8 ragged
   grouped FFN (K7) on rank (0, 0)'s chunk 0 of the pipelined int8 plan
   (8 chunks of 15 + 2 slots, int8-encoded payload, counts through the
   chains), the dense grouped FFN (K6) at the einsum phase's [64, 128,
   1024] buffer (rows past each expert's count of a top-2 route of
   random tokens zero; plus swiglu and C = 100 edge shapes), and decode attention (K8)
   at B = 32 requests against a 32768-row cache (16 heads of 64, NaN in
   every row past a request's length; plus GQA, window, L = 1000 and
   length-0 edge cases), with kernel, plain, bound and library times (K1
   ``index_select``, K2 ``embedding_bag``, K5 and K8
   ``scaled_dot_product_attention``; K6 has no one-call library
   counterpart, and the cuBLAS chain bmm -> gelu -> bmm is timed beside
   it as ``bmm_chain_ms``);
4. backward checks — each K1-K4, K6 and K7 ``autograd.Function`` on the
   card against autograd of its plain version (K7: of the full-precision
   plain version, its straight-through rule) at a small shape, and K1's
   and K2's at the 2x2 plan's rank-0 layout;
5. serve   — gpt3_medium_moe at full width (12 layers, d=1024, 64
   experts top-2, vocab 50304, bf16, random weights from a seed) through
   ``ServingEngine.run``: 8 requests, 8 slots, packs of 4, prompt bucket
   128, cache 256.  Checks every stream's budget and vocabulary, that the
   launch counters show every MoE layer of every step went through K4 and
   every prefill attention through K5, and that on a small input the
   kernel path is as close to a float32 plain run as the bf16 plain path;
6. profile — host-clock step times and a torch.profiler breakdown
   (device busy share, top kernels) of one prefill pack and one decode
   step;
7. train_1rank — in a child process, ``trainer.train`` of full-width
   gpt3_medium_moe on one rank: ``dispatch="a2a"``, ``aux_mode="ta"``,
   seq 512, batch 4, AdamW, 3 steps.  K4 must launch once per layer and
   forward (36 times), and the first step's loss must agree with the plain
   path's (kernels off) on the same weights and batch;
8. train_2x2 — the same on a 2x2 (pod x data) EP world of four spawned
   ranks that share the card over gloo, batch 8 (1024 tokens a rank):
   every rank must launch K1, K2 and K3 36 times each and K4 never, the
   ranks must agree on the world-mean losses, and the first step's loss
   must agree with the plain path's.  Each rank profiles one more step
   twice: as shipped, and with the earlier spare-row backwards of K1 and
   K2 (``spare_row_backwards``), reporting the device time inside each
   backward's profiler range (``BACKWARD_RANGES``);
9. train_2x2_pipelined — the same world through ``dispatch=
   "a2a_pipelined"`` with the int8 wire codec and the overlap model's
   chunk count (8), 2 steps: every rank must launch K1, K2 and K7 192
   times each (12 layers x 8 chunks x 2 steps) and K3 and K4 never, and
   the first step's loss must agree with the plain path's within
   LOSS_RTOL_INT8;
10. train_einsum_k6 — in a child process, full-width gpt3_medium_moe on
   one rank through the paper's einsum baseline (``dispatch="einsum"``,
   ``aux_mode="lb"``, ``build_ctx(use_moe_kernel=True)``, capacity 128)
   with ``trainer.make_train_step``: seq 512, batch 4, AdamW, 3 steps.  K6
   must launch once per layer and forward (36 times), and the first
   step's loss must agree with the plain path's (``REPRO_TORCH_KERNELS=0``:
   ``grouped_ffn_ref``) on the same weights and batch;
11. kernels — one ``{"kernels": [...]}`` line for K1-K8, launches
   summed over the main paths (serve, train_1rank, every rank of
   train_2x2 and train_2x2_pipelined, train_einsum_k6).  K8 lies on no
   path (no model calls it, as in the reference): its row gives the
   launches of its checks as ``check_launches``.

Every earlier phase must show no launch of K6 and K8, and no training
phase's plain run may launch any kernel.
Any failed phase raises (exit code non-zero).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import gc
import json
import math
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

ARCH_ID = "gpt3_medium_moe"
NUM_SLOTS, PACK, BUCKET, CACHE_LEN = 8, 4, 128, 256
NUM_REQUESTS = 8
# H100 SXM published dense peaks (NVIDIA data sheet), used for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_INT8_OPS_PER_S = 1979e12
# kernel vs plain tolerances in bf16: |kernel - plain| <= ATOL + RTOL*|plain|.
# K4: the plain version rounds each expert row to bf16 before the weighted
# combine (the kernel combines its f32 accumulator), and f32 sums run in
# another order (atomics in the kernel): a few bf16 ulps of |y| ~ 1.
K4_ATOL, K4_RTOL = 3e-2, 2e-2
# K5: both run in f32 and round the output to bf16 once: one bf16 ulp.
K5_ATOL, K5_RTOL = 1e-2, 1e-2
# K2: both sum K = 2 weighted bf16 rows in f32; the kernel fuses each
# multiply-add (one rounding fewer): an f32 ulp or two of |out| ~ 1.
K2_ATOL, K2_RTOL = 1e-5, 1e-5
# K3: as K4 (bf16 output of f32 sums taken in another order).  K1 copies
# rows and must be bit-equal.
K3_ATOL, K3_RTOL = 3e-2, 2e-2
# K7: its integer sums are exact on both sides and both dequantize with the
# same f32 factors; the rest is K3's (bf16 hidden and output, f32 sums of
# the down-projection in another order)
K7_ATOL, K7_RTOL = K3_ATOL, K3_RTOL
# K6: K3's arithmetic on equal, full segments (bf16 hidden and output of f32
# sums taken in another order)
K6_ATOL, K6_RTOL = K3_ATOL, K3_RTOL
# K8: f32 inside on both sides, then one bf16 rounding of the output.  The
# split combine sums in another order than the plain softmax, which leaves
# the two f32 results a few f32 ulps apart; the rounding then puts them at
# most one bf16 ulp apart, at most 2^-7 of the value, which RTOL covers.
# ATOL is kept small because the outputs are: a request of length n averages n
# unit-variance v rows, so |out| ~ n^-1/2, about 0.013 at the main shape's
# median length.  Sound H100 runs read at most 2.4e-4 max abs error, all
# of it within RTOL (4.1e-9 beyond it).  A planted fault that drops one
# 512-row split from each request longer than 24k rows needed an atol of
# 5.3e-3 on an H100: caught here, not by K5's 1e-2 + 1e-2*|plain|.
K8_ATOL, K8_RTOL = 1e-4, 1e-2
# the library call SDPA is only the K8 row's yardstick: its check against
# the plain version keeps K5's tolerance
K8_LIB_ATOL, K8_LIB_RTOL = K5_ATOL, K5_RTOL
# K8's main check: the reference's decode_32k cache length, gpt3_medium_moe's
# heads, 32 requests (a 4.3 GB bf16 cache)
DECODE_B, DECODE_L = 32, 32768
# backward checks: a Function on the card against autograd of its plain
# version, |got - want| <= ATOL + RTOL * max|want| per tensor.  f32 (K1,
# K2): scatter-adds by atomics in another order.  bf16 inputs (K3, K4):
# the same plain arithmetic, but autograd's scatter-add of the weight
# gradients over an expert's segments runs in bf16 with atomics, so the
# order of those sums (a few bf16 ulps of the largest entry) changes from
# run to run.
BWD_F32_ATOL, BWD_F32_RTOL = 1e-5, 1e-5
BWD_BF16_ATOL, BWD_BF16_RTOL = 1e-2, 3e-2
# training phases: full width, seq 512, 3 steps; one rank with batch 4
# (2048 tokens, caps (128,)), the 2x2 world with batch 8 (1024 tokens a
# rank, caps (120, 16))
TRAIN_SEQ, TRAIN_STEPS = 512, 3
# the pipelined phase's steps take about 10 s each over gloo; two keep the
# whole smoke near its earlier length and still check a step that starts
# from updated weights
PIPELINED_STEPS = 2
TRAIN_BATCH_1, TRAIN_BATCH_22 = 4, 8
WORLD_22 = (2, 2)
# first-step world-mean loss, kernel path against the plain path, both in
# bf16: the kernels round and sum in other orders, which can flip a few
# near-tied top-2 picks in later layers; the loss is a mean over 2048
# tokens (4096 in the world), so it moves far less than one token's share.
# Sound runs on an H100 gave 9.3e-5 (one rank) and 1.4e-4 (2x2 world).
LOSS_RTOL = 1e-3
# the int8 wire's phase: the kernel path quantizes each (expert, stage,
# source) segment with its own scale, the plain path each expert's chunk
# span with one, so the two first-step losses differ by more than bf16
# rounding: 3.0e-4 relative in sound runs on an H100.  Faults planted in
# K7's per-segment scales (chip_k7_guard.py) moved it by 8.1e-3 (stage-1
# segments x1.25), 1.1e-2 (stage-1 zeroed, or every segment x1.1) and
# 3.5e-2 (stage-1 x2); the limit sits 5x above the sound gap and 5x below
# the smallest of those.
LOSS_RTOL_INT8 = 1.5e-3
PIPELINED_CHUNKS = 8      # the overlap model's pick for the 2x2 plan
# end to end after 12 bf16 layers, relative Frobenius error of the logits
# against a float32 plain run: the kernel path may be at most E2E_RATIO
# times as far from it as the plain bf16 path (both differ from float32 by
# bf16 rounding, which random-weight layers amplify), or E2E_FLOOR
E2E_RATIO, E2E_FLOOR = 1.5, 1e-2
# kernels no earlier phase may launch: K6 runs only on the einsum phase, K8
# on no path
OFF_PATH = ("moe_gemm.grouped_ffn", "decode_attn.decode_attention")
# the profiler ranges of the backwards written for K1 and K2 and of the
# ragged FFN's (K3's and K7's) backward, whose device time a profiled
# training step reports
BACKWARD_RANGES = ("moe_permute.permute.backward",
                   "moe_permute.unpermute.backward",
                   "moe_gemm.grouped_ffn_ragged.backward")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(torch, got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def atol_needed(torch, got, want, rtol) -> float:
    """The least atol with which ``close(got, want, atol, rtol)`` holds."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - rtol * want.abs()).max().clamp(min=0))


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOP_PER_S + int8_ops / PEAK_INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gather_k4_case(torch, params, ctx, Tg: int, gen, swiglu=False):
    """K4's inputs at the gather path's slot layout for Tg tokens of layer
    0: one segment per expert, every row of a picked expert's segment
    valid.  With ``swiglu`` (not gpt3_medium_moe's activation) a random
    gate projection is added, to hold the kernel's swiglu branch too."""
    from repro_torch.core import gating
    from repro_torch.core.dispatch import routing, transport
    p = params["layers"][0]["ffn"]
    d, E = ctx.arch.d_model, ctx.arch.moe.num_experts
    x = torch.randn((Tg, d), generator=gen, device="cuda").to(torch.bfloat16)
    gate_out = gating.gate_forward(p["gate"], x, ctx.gate_cfg)
    tok, w, valid = routing.gather_slots(gate_out, 0, E)
    w_gate, act = None, "gelu"
    if swiglu:
        w_gate = (torch.randn(p["w_in"].shape, generator=gen, device="cuda")
                  * d ** -0.5).to(torch.bfloat16)
        act = "swiglu"
    return (x, tok, w, transport.expert_segments(E, Tg), tuple(range(E)),
            valid, p["w_in"], w_gate, p["w_out"]), act


def train1_k4_case(torch, params, arch, gen):
    """K4's inputs at the one-rank training layout: a real ``route`` +
    ``build_indices`` of TRAIN_SEQ * TRAIN_BATCH_1 = 2048 random tokens
    through layer 0's gate on the one-rank plan (caps (128,)), laid out by
    the engine's ``local_layout``: 64 segments of 128 slots, partly filled,
    with sentinel slots past each expert's realized rows."""
    from repro_torch.core.dispatch import engine as engine_lib
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.launch.mesh import unit_world
    from repro_torch.models import model as model_lib
    world = unit_world("cuda")
    ctx = model_lib.build_ctx(arch, None, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_1, aux_mode="ta",
                              dispatch="a2a", device="cuda")
    T = TRAIN_SEQ * TRAIN_BATCH_1
    p = params["layers"][0]["ffn"]
    x = torch.randn((T, arch.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    routed = routing.route(p, x, ctx.moe_cfg, ctx.ep, ctx.plan, ctx.gate_cfg,
                           world.coords)
    stages = transport.plan_stages(ctx.plan, ctx.ep)
    local = [(stage, sel) for (_, sel), stage in zip(routed.sels, stages)
             if stage.num_dests == 1]
    if len(local) != len(stages):
        raise SystemExit(f"train_1rank layout: {len(stages) - len(local)} "
                         f"of {len(stages)} stages are not local on one rank")
    li, offs, exps = engine_lib.local_layout(
        local, routed.gate_out["topk_idx"], T, p["w_in"].shape[0])
    return (x, li.slot_to_token, li.slot_w, offs, exps, li.rows_per_expert,
            p["w_in"], None, p["w_out"]), "gelu"


def check_k4(torch, args, act: str, label: str, timed=True):
    """K4 against its plain version on one layout's inputs (``args`` in
    ``local_moe``'s order), with kernel, plain and bound times."""
    from repro_torch.kernels.moe_fused import ops as fused_ops
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    x, tok, w, offs, exps, valid, w_in, _, _ = args
    Tg, d = x.shape
    f = w_in.shape[2]

    def kernel():
        return fused_ops.local_moe(*args, activation=act, use_pallas=True)

    def plain():
        return local_moe_ref(*args, activation=act)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K4_ATOL, K4_RTOL)
    if not ok:
        raise SystemExit(f"K4 {label}: kernel disagrees with plain "
                         f"(max abs err {err})")
    if not timed:
        return {"layout": label, "Tg": Tg, "activation": act,
                "max_abs_err": err, "atol": K4_ATOL, "rtol": K4_RTOL}
    iters = 50 if Tg <= 64 else 10
    ms = time_ms(torch, kernel, iters)
    plain_ms = time_ms(torch, plain, max(3, iters // 5))
    # the bound counts the work the output needs: the rows with a nonzero
    # combine weight, and the weights of the experts that hold valid rows.
    # Rows the kernel computes past weighted_rows (the dense gather layout
    # computes every row of a picked expert's segment) are wasted work.
    computed_rows = int(valid.sum())
    weighted_rows = int((w != 0).sum())
    active = len({e for e, v in zip(exps, valid.tolist()) if v > 0})
    nbytes = (Tg * d * 2 + tok.numel() * 4 + w.numel() * 4 + len(exps) * 4
              + active * 2 * d * f * 2 + Tg * d * 4)
    flops = 2 * weighted_rows * 2 * d * f
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"layout": label, "Tg": Tg, "slots": tok.numel(),
            "segments": len(exps), "active_experts": active,
            "computed_rows": computed_rows, "weighted_rows": weighted_rows,
            "max_abs_err": err, "atol": K4_ATOL, "rtol": K4_RTOL, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def check_k5(torch, shape, gen, causal=True, window=0, timed=True):
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    F = torch.nn.functional
    B, S, H, hd = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))

    def kernel():
        return fa_ops.flash_attention(q, k, v, causal=causal,
                                      sliding_window=window, use_pallas=True)

    def plain():
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=window)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K5_ATOL, K5_RTOL)
    if not ok:
        raise SystemExit(f"K5 {shape} causal={causal} window={window}: "
                         f"kernel disagrees with plain (max abs err {err})")
    out = {"shape": list(shape), "causal": causal, "window": window,
           "max_abs_err": err, "atol": K5_ATOL, "rtol": K5_RTOL}
    if not timed:
        return out
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = 4 * B * S * H * hd * 2
    flops = 2 * 2 * B * H * hd * pairs
    b_ms, b_by = bound_ms(nbytes, flops)
    out.update(ms=time_ms(torch, kernel, 100),
               plain_ms=time_ms(torch, plain, 20),
               library_ms=time_ms(torch, library, 100),
               bound_ms=b_ms, bound_by=b_by)
    return out


def staged_case(torch, params, arch, gen):
    """Rank (0, 0)'s view of the 2x2 training phase's plan: a real
    ``route`` + ``build_indices`` of 1024 random tokens through layer 0's
    gate, the 2x2 EP spec and its Eq. (7) plan (caps (120, 16)).  The
    rank's send buffer, read back through an identity exchange, stands in
    for the receive buffer of the ragged grouped FFN (K3)."""
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.kernels.moe_permute.ref import permute_ref
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model as model_lib
    world = EPWorld(axis_names=("pod", "data"), axis_sizes=WORLD_22,
                    coords=(0, 0), device="cuda")
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_22, aux_mode="ta",
                              device="cuda")
    T = TRAIN_SEQ * TRAIN_BATCH_22 // world.size
    d = arch.d_model
    p = params["layers"][0]["ffn"]
    x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
    routed = routing.route(p, x, ctx.moe_cfg, ctx.ep, ctx.plan, ctx.gate_cfg,
                           world.coords)
    di = routing.build_indices(routed.sels, routed.gate_out["topk_idx"], T)
    stages = transport.plan_stages(ctx.plan, ctx.ep)
    flat = permute_ref(x, di.slot_to_token)

    def ident(t, axis, dim):
        return t

    parts, cnts = [], []
    for stage, (_, off, shape), (_, coff, cshape) in zip(
            stages, di.stage_spans(), di.expert_spans()):
        n = math.prod(shape)
        parts.append(transport.dispatch_chain(
            flat[off:off + n].reshape(shape + (d,)), stage, ident))
        cnts.append(transport.counts_chain(
            di.rows_per_expert[coff:coff + math.prod(cshape)].reshape(cshape),
            stage, ident))
    E_l = ctx.plan.experts_per_rank
    segs, exps = transport.stage_segments(
        E_l, tuple((s.num_dests, shape[-1])
                   for s, (_, _, shape) in zip(stages, di.stage_spans())))
    return {"x": x, "di": di, "caps": ctx.plan.caps,
            "xin": torch.cat(parts, dim=1).reshape(-1, d).contiguous(),
            "rows_valid": torch.cat(cnts, dim=1).reshape(-1).contiguous(),
            "segs": segs, "exps": exps,
            "w_in": p["w_in"][:E_l].contiguous(),
            "w_out": p["w_out"][:E_l].contiguous()}


def check_k1(torch, x, tok):
    """K1 permute at one layout of the 2x2 world's rank 0 (``x`` [T, d],
    ``slot_to_token`` ``tok`` [S]): a row copy, so the kernel must equal
    the plain version bit for bit.  ``ms`` times 200 calls under no_grad;
    ``chip_ab.permute_readings`` adds ``device_ms``, ``call_ms`` and
    ``host_us`` for the kernel and ``index_select`` alike, and the bound."""
    import chip_ab
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import permute_ref
    out = chip_ab.permute_readings(torch, p_ops, x, tok, time_ms, bound_ms)
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    idx = tok.long()
    out.update(
        max_abs_err=0.0, atol=0.0,
        ms=time_ms(torch, lambda: p_ops.permute(x, tok, use_pallas=True),
                   200),
        plain_ms=time_ms(torch, lambda: permute_ref(x, tok), 50),
        library_ms=time_ms(torch, lambda: x_pad.index_select(0, idx), 200))
    return out


def check_k2(torch, y, di):
    """K2 unpermute at one layout of the 2x2 world's rank 0, on bf16 slot
    rows ``y`` [S, d]: within K2_ATOL + K2_RTOL·|plain| of the plain
    version.  ``ms`` times 200 calls under no_grad; ``library_ms``
    ``embedding_bag`` over an f32 table with the zero row the sentinel S
    reads (f32, so it matches K2's f32 output; built outside the timed
    region); ``chip_ab.unpermute_readings`` adds ``device_ms``,
    ``call_ms`` and ``host_us`` for both, and the bound."""
    import chip_ab
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import unpermute_ref
    out = chip_ab.unpermute_readings(torch, p_ops, y, di.inv_idx, di.inv_w,
                                     time_ms, bound_ms, K2_ATOL, K2_RTOL)
    y_pad = torch.cat([y, y.new_zeros((1, y.shape[1]))]).float()
    inv_idx = di.inv_idx.long()
    out.update(
        ms=time_ms(torch, lambda: p_ops.unpermute(y, di.inv_idx, di.inv_w,
                                                  use_pallas=True), 200),
        plain_ms=time_ms(torch, lambda: unpermute_ref(y, di.inv_idx,
                                                      di.inv_w), 50),
        library_ms=time_ms(torch, lambda: torch.nn.functional.embedding_bag(
            inv_idx, y_pad, per_sample_weights=di.inv_w, mode="sum"), 200),
        library_call="embedding_bag, f32 table")
    return out


def permute_edges(torch, gen):
    """K1 against its plain version, bit for bit, where the main layouts do
    not reach: other element types, the narrowest row (16 bytes), a wide
    one (48 KB: many passes a warp), a row that leaves the last pass
    partly empty, S = 0, no token row (T = 0), every slot a sentinel, an
    odd S, and a large one; an x the 16-byte copies cannot take must be
    refused."""
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import permute_ref
    bf = torch.bfloat16
    cases = [("f32", 1024, 1024, 4864, torch.float32),
             ("fp16", 1024, 1024, 4864, torch.float16),
             ("d=8 bf16", 1024, 8, 4864, bf),
             ("S=0", 1024, 1024, 0, bf),
             ("T=0", 0, 1024, 300, bf),
             ("all sentinel", 1024, 1024, 4864, bf),
             ("S=4877", 1024, 1024, 4877, bf),
             ("S=20011", 1024, 1024, 20011, bf),
             ("d=1000 bf16", 1024, 1000, 4864, bf),
             ("48 KB rows", 64, 12288, 300, torch.float32)]
    out = []
    for label, T, d, S, dtype in cases:
        x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
        hi = 1 if label == "all sentinel" else T + 1
        tok = torch.randint(0, hi, (S,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if label == "all sentinel":
            tok += T
        got = p_ops.permute(x, tok, use_pallas=True)
        want = permute_ref(x, tok)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K1 {label}: kernel disagrees with plain")
        out.append({"case": label, "T": T, "d": d, "S": S,
                    "dtype": str(dtype), "max_abs_err": 0.0})
    flat = torch.zeros(64 * 1024 + 1, device="cuda", dtype=bf)
    for label, x in (("x not 16-byte aligned", flat[1:].view(64, 1024)),
                     ("rows of 12 bytes",
                      torch.zeros((64, 3), device="cuda"))):
        try:
            p_ops.permute(x, torch.zeros(8, device="cuda",
                                         dtype=torch.int32), use_pallas=True)
        except ValueError as e:
            out.append({"case": label, "refused": str(e)})
        else:
            raise SystemExit(f"K1 {label}: the wrapper did not refuse it")
    return out


def unpermute_edges(torch, gen):
    """K2 against its plain version (K2_ATOL + K2_RTOL·|plain|) where the
    main layouts do not reach: K = 1 and K = 4 and 40 (the any-K
    instance, 40 over two rounds of the warp's shuffle), f32 rows, a row
    width that leaves the last pass partly empty, tokens whose picks are
    all dropped (exact zeros, also where a dropped pick keeps a weight),
    and a T that the blocks' four tokens do not divide."""
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import unpermute_ref
    cases = [("K=1", 1024, 4864, 1024, 1, torch.bfloat16),
             ("K=4", 1024, 4864, 1024, 4, torch.bfloat16),
             ("K=40", 256, 4864, 1024, 40, torch.bfloat16),
             ("f32 y", 1024, 4864, 1024, 2, torch.float32),
             ("f32 y, K=4", 1024, 4864, 1024, 4, torch.float32),
             ("d=1000", 1024, 4864, 1000, 2, torch.bfloat16),
             ("all dropped", 1024, 4864, 1024, 2, torch.bfloat16),
             ("T=1023", 1023, 4864, 1024, 2, torch.bfloat16)]
    out = []
    for label, T, S, d, K, dtype in cases:
        y = torch.randn((S, d), generator=gen, device="cuda").to(dtype)
        inv_idx = torch.randint(0, S + 1, (T, K), generator=gen,
                                device="cuda", dtype=torch.int32)
        inv_w = torch.rand((T, K), generator=gen, device="cuda")
        if label == "all dropped":
            inv_idx[T // 2:] = S          # half the tokens drop every pick;
            inv_w[T // 2::2] = 0.0        # every other one keeps its weights
        else:
            inv_w = torch.where(inv_idx < S, inv_w, 0.0)
        got = p_ops.unpermute(y, inv_idx, inv_w, use_pallas=True)
        want = unpermute_ref(y, inv_idx, inv_w)
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K2_ATOL, K2_RTOL)
        dead = (inv_idx >= S).all(dim=1)
        if not ok or not bool((got[dead] == 0).all()):
            raise SystemExit(f"K2 {label}: kernel disagrees with plain "
                             f"(max abs err {err})")
        out.append({"case": label, "T": T, "S": S, "d": d, "K": K,
                    "dtype": str(dtype), "dropped_tokens": int(dead.sum()),
                    "max_abs_err": err})
    return out


def check_k3(torch, case):
    """K3 ragged grouped FFN on the 2x2 phase's receive layout: 16
    experts, 96 segments of width 120 or 16, tanh-gelu."""
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    w_in, w_out = case["w_in"], case["w_out"]

    def kernel():
        return g_ops.grouped_ffn_ragged(xin, segs, exps, valid, w_in, None,
                                        w_out, activation="gelu",
                                        use_pallas=True)

    def plain():
        return grouped_ffn_ragged_ref(xin, segs, exps, valid, w_in, None,
                                      w_out, activation="gelu")

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K3_ATOL, K3_RTOL)
    R, d = xin.shape
    f = w_in.shape[2]
    offs = torch.as_tensor(segs, device="cuda")
    widths = offs[1:] - offs[:-1]
    zeros_exact = bool((got[dead_rows(torch, segs, valid, R)] == 0).all())
    if not ok or not zeros_exact:
        raise SystemExit(f"K3: kernel disagrees with plain (max abs err "
                         f"{err}, rows past nvalid zero: {zeros_exact})")
    nvalid = int(valid.sum())
    per_expert = torch.zeros(w_in.shape[0], device="cuda").index_add_(
        0, torch.as_tensor(exps, device="cuda"), valid.float())
    active = int((per_expert > 0).sum())
    nbytes = (nvalid * d * 2 + active * 2 * d * f * 2 + R * d * 2
              + valid.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * nvalid * 2 * d * f)
    return {"R": R, "segments": len(exps), "experts": w_in.shape[0],
            "segment_widths": sorted({int(w) for w in widths.tolist()}),
            "valid_rows": nvalid, "active_experts": active,
            "max_abs_err": err, "atol": K3_ATOL, "rtol": K3_RTOL,
            "ms": time_ms(torch, kernel, 20),
            "plain_ms": time_ms(torch, plain, 5), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


def pipelined_case(torch, params, arch, gen):
    """Rank (0, 0)'s view of chunk 0 of the train_2x2_pipelined phase: a
    real ``route`` + ``build_indices`` of 1024 random tokens through layer
    0's gate on the 2x2 EP spec and the int8 wire's chunk-aligned plan
    (caps (120, 16), 8 chunks: 15 and 2 slots of the two stages a chunk),
    the payload int8-encoded and decoded and the valid-row counts moved
    through the transport's chains, as the engine does.  An identity
    exchange stands in for the all-to-alls: the rank's send buffer is the
    receive buffer of the int8 ragged grouped FFN (K7)."""
    import types
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.kernels.moe_permute.ref import permute_ref
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model as model_lib
    world = EPWorld(axis_names=("pod", "data"), axis_sizes=WORLD_22,
                    coords=(0, 0), device="cuda")
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_22, aux_mode="ta",
                              dispatch="a2a_pipelined", wire_codec="int8",
                              device="cuda")
    k = ctx.a2a_num_chunks
    if k != PIPELINED_CHUNKS:
        raise SystemExit(f"pipelined plan: {k} chunks, expected "
                         f"{PIPELINED_CHUNKS}")
    T = TRAIN_SEQ * TRAIN_BATCH_22 // world.size
    d = arch.d_model
    p = params["layers"][0]["ffn"]
    x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
    routed = routing.route(p, x, ctx.moe_cfg, ctx.ep, ctx.plan, ctx.gate_cfg,
                           world.coords)
    stages = transport.plan_stages(ctx.plan, ctx.ep)
    work = []
    for (s, sel), stage in zip(routed.sels, stages):
        sel = routing.pad_selection(sel, axis=s + 2, multiple=k)
        cpc = sel.idx.shape[s + 2] // k
        work.append((stage, routing.slice_selection(sel, s + 2, 0, cpc), cpc))
    di = routing.build_indices(tuple((st.index, sel) for st, sel, _ in work),
                               routed.gate_out["topk_idx"], T)
    tr = transport.A2ATransport(
        ep=ctx.ep, world=types.SimpleNamespace(
            all_to_all=lambda t, axis, dim: t), codec=ctx.wire_codec)
    flat = permute_ref(x, di.slot_to_token)
    parts, cnts = [], []
    for (stage, _, _), (_, off, shape), (_, coff, cshape) in zip(
            work, di.stage_spans(), di.expert_spans()):
        parts.append(tr.dispatch(
            flat[off:off + math.prod(shape)].reshape(shape + (d,)), stage))
        cnts.append(tr.dispatch_counts(
            di.rows_per_expert[coff:coff + math.prod(cshape)].reshape(cshape),
            stage))
    E_l = ctx.plan.experts_per_rank
    segs, exps = transport.stage_segments(
        E_l, tuple((stage.num_dests, cpc) for stage, _, cpc in work))
    return {"x": x, "di": di, "caps": ctx.plan.caps, "chunks": k,
            "chunk_caps": [cpc for _, _, cpc in work],
            "xin": torch.cat(parts, dim=1).reshape(-1, d).contiguous(),
            "rows_valid": torch.cat(cnts, dim=1).reshape(-1).contiguous(),
            "segs": segs, "exps": exps,
            "w_in": p["w_in"][:E_l].contiguous(),
            "w_out": p["w_out"][:E_l].contiguous()}


def dead_rows(torch, segs, valid, R):
    """[R] bool: the rows at or past their segment's valid count."""
    offs = torch.as_tensor(segs, device="cuda")
    rows = torch.arange(R, device="cuda")
    seg_of = torch.searchsorted(offs[1:], rows, right=True)
    return (rows - offs[seg_of]) >= valid[seg_of].long()


def check_k7(torch, case):
    """K7 on chunk 0 of the pipelined int8 plan against its plain version
    on the same segments (so the same per-segment and per-expert scales),
    with kernel, plain, bound times and the time of the plain-torch
    quantization the wrapper runs before the launch."""
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                                  quantize_experts,
                                                  quantize_segments)
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    w_in, w_out = case["w_in"], case["w_out"]

    def kernel():
        return g_ops.grouped_ffn_ragged_quant(xin, segs, exps, valid, w_in,
                                              None, w_out, activation="gelu",
                                              use_pallas=True)

    def plain():
        return grouped_ffn_ragged_quant_ref(xin, segs, exps, valid, w_in,
                                            None, w_out, activation="gelu")

    def quantize():
        return quantize_segments(xin, segs), quantize_experts(w_in)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K7_ATOL, K7_RTOL)
    R, d = xin.shape
    f = w_in.shape[2]
    zeros_exact = bool((got[dead_rows(torch, segs, valid, R)] == 0).all())
    if not ok or not zeros_exact:
        raise SystemExit(f"K7: kernel disagrees with plain (max abs err "
                         f"{err}, rows past nvalid zero: {zeros_exact})")
    nvalid = int(valid.sum())
    per_expert = torch.zeros(w_in.shape[0], device="cuda").index_add_(
        0, torch.as_tensor(exps, device="cuda"), valid.float())
    active = int((per_expert > 0).sum())
    # int8 valid rows, the int8 w_in and bf16 w_out of the experts used, the
    # bf16 [R, d] output; 2df int8 and 2fd bf16 operations a valid row
    nbytes = nvalid * d + active * (d * f + f * d * 2) + R * d * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * nvalid * f * d,
                          int8_ops=2.0 * nvalid * d * f)
    widths = {offs1 - offs0 for offs0, offs1 in zip(segs[:-1], segs[1:])}
    return {"R": R, "segments": len(exps), "experts": w_in.shape[0],
            "caps": list(case["caps"]), "chunks": case["chunks"],
            "chunk_caps": case["chunk_caps"],
            "segment_widths": sorted(widths), "valid_rows": nvalid,
            "active_experts": active, "max_abs_err": err, "atol": K7_ATOL,
            "rtol": K7_RTOL, "ms": time_ms(torch, kernel, 20),
            "quantize_ms": time_ms(torch, quantize, 20),
            "plain_ms": time_ms(torch, plain, 5), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


def einsum_k6_case(torch, params, arch, gen):
    """K6's input at the einsum phase's shape: the [64, 128, 1024] bf16
    capacity buffer of 2048 random tokens routed top-2 through layer 0's
    gate (capacity 128 by the capacity-factor rule), with each expert's
    rows past its count (capped at the capacity) zero, as the one-hot
    dispatch leaves them; layer 0's w_in and w_out.  The occupancy is
    these random tokens' (about half the rows), not the phase's, whose
    batches drop more picks; K6 computes every row of the buffer either
    way, so its time does not depend on it."""
    from repro_torch.core import gating
    from repro_torch.models import model as model_lib
    ctx = model_lib.build_ctx(arch, None, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_1, aux_mode="lb",
                              dispatch="einsum", use_moe_kernel=True,
                              device="cuda")
    moe = ctx.moe_cfg
    T = TRAIN_SEQ * TRAIN_BATCH_1
    E, d = moe.num_experts, moe.d_model
    C = int(T * moe.top_k * moe.capacity_factor / E)
    p = params["layers"][0]["ffn"]
    tokens = torch.randn((T, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
    gate_out = gating.gate_forward(p["gate"], tokens, ctx.gate_cfg)
    counts = torch.bincount(gate_out["topk_idx"].reshape(-1).long(),
                            minlength=E).clamp(max=C)
    x = torch.randn((E, C, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    x[torch.arange(C, device="cuda")[None, :] >= counts[:, None]] = 0
    return x, p["w_in"], p["w_out"], int(counts.sum())


def check_k6(torch, x, w_in, w_gate, w_out, label: str, filled=None,
             timed=True):
    """K6 (``grouped_ffn``, which launches the kernel for CUDA tensors)
    against its plain version; when timed, with kernel, plain and bound
    times and the cuBLAS chain bmm -> gelu -> bmm on the same inputs."""
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ref
    F = torch.nn.functional
    act = "gelu" if w_gate is None else "swiglu"
    E, C, d = x.shape
    f = w_in.shape[2]

    def kernel():
        return g_ops.grouped_ffn(x, w_in, w_gate, w_out, activation=act)

    def plain():
        return grouped_ffn_ref(x, w_in, w_gate, w_out, activation=act)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ok, err = close(torch, got, want, K6_ATOL, K6_RTOL)
    if not ok:
        raise SystemExit(f"K6 {label}: kernel disagrees with plain (max abs "
                         f"err {err})")
    out = {"layout": label, "shape": [E, C, d], "f": f, "activation": act,
           "max_abs_err": err, "atol": K6_ATOL, "rtol": K6_RTOL}
    if not timed:
        return out

    def bmm_chain():
        return torch.bmm(F.gelu(torch.bmm(x, w_in), approximate="tanh"),
                         w_out)

    _, chain_err = close(torch, bmm_chain(), want, K6_ATOL, K6_RTOL)
    filled = E * C if filled is None else filled
    n_w = 3 if w_gate is not None else 2
    nbytes = 2 * E * C * d * 2 + n_w * E * d * f * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * filled * n_w * d * f)
    out.update(filled_rows=filled, ms=time_ms(torch, kernel, 20),
               plain_ms=time_ms(torch, plain, 5), library_ms=None,
               bmm_chain_ms=time_ms(torch, bmm_chain, 20),
               bmm_chain_max_abs_err=chain_err, bound_ms=b_ms, bound_by=b_by)
    return out


def check_k8(torch, gen, B: int, L: int, H: int, K: int, lengths=None,
             window: int = 0, timed=False):
    """K8 (``decode_attention``) against its plain version on a bf16 cache
    with NaN in every k/v row past its request's length, compared on the
    requests with a valid row; the requests with none must come out as
    exact zeros.  ``lengths`` None draws them in [1, L] with one at L and
    one at 1.  When timed, with plain, bound and SDPA times (SDPA on a copy
    of the cache with the NaN rows zeroed, checked first)."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.decode_attn import ops as d_ops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    F = torch.nn.functional
    hd = d_ops.HEAD_DIM
    if lengths is None:
        lengths = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
        lengths[0], lengths[1] = L, 1
    lens = torch.as_tensor(lengths, device="cuda").to(torch.int32)
    q = torch.randn((B, H, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, L, K, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(L, device="cuda")
    past = pos[None, :] >= lens[:, None].long()              # [B, L]
    k[past], v[past] = float("nan"), float("nan")
    launches0 = backend.LAUNCHES[d_ops.KERNEL]

    def kernel():
        return d_ops.decode_attention(q, k, v, lens, sliding_window=window)

    def plain():
        return decode_attention_ref(q, k, v, lens, sliding_window=window)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    live = lens > 0
    ok, err = close(torch, got[live], want[live], K8_ATOL, K8_RTOL)
    need = atol_needed(torch, got[live], want[live], K8_RTOL)
    zeros_exact = bool((got[~live] == 0).all())
    if not ok or not zeros_exact:
        raise SystemExit(f"K8 B={B} L={L} H={H} K={K} window={window}: "
                         f"kernel disagrees with plain (max abs err {err}, "
                         f"atol needed {need} > {K8_ATOL}, length-0 "
                         f"requests zero: {zeros_exact})")
    valid = ~past
    if window:
        valid &= pos[None, :] >= lens[:, None].long() - window
    rows = int(valid.sum())
    out = {"B": B, "L": L, "H": H, "K": K, "window": window,
           "zero_length_requests": int((~live).sum()), "valid_rows": rows,
           "max_abs_err": err, "atol_needed": need, "atol": K8_ATOL,
           "rtol": K8_RTOL}
    if timed:
        keep = valid[:, :, None, None]
        kc, vc = (torch.where(keep, t, 0).transpose(1, 2) for t in (k, v))
        mask = valid[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                  attn_mask=mask)[:, :, 0]

        lib_ok, lib_err = close(torch, library()[live], want[live],
                                K8_LIB_ATOL, K8_LIB_RTOL)
        if not lib_ok:
            raise SystemExit(f"K8: the library call scaled_dot_product_"
                             f"attention disagrees with plain (max abs err "
                             f"{lib_err})")
        # the valid rows' k and v, q, the lengths and the output once; two
        # products of hd a valid row and query head
        nbytes = rows * K * hd * 2 * 2 + 2 * B * H * hd * 2 + B * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * rows * (H // K) * K * hd)
        out.update(ms=time_ms(torch, kernel, 20),
                   plain_ms=time_ms(torch, plain, 3),
                   library_ms=time_ms(torch, library, 10),
                   library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by)
        del kc, vc
    out["launches"] = backend.LAUNCHES[d_ops.KERNEL] - launches0
    return out


def backward_checks(torch, gen, layout22):
    """Each kernel's ``autograd.Function`` on the card against autograd of
    its plain version, at a small shape: K1 and K2 in float32 (their
    backwards are written by hand; also at ``layout22``, ``(T, di)`` of the
    2x2 world's rank 0, a real route with about two thirds of the slots
    sentinels and a quarter of the picks dropped, at full width), K3, K4,
    K6 and K7 on bf16 inputs (their
    kernels take bf16 only; their backwards are autograd through the plain
    version).  K7's gradients are held against autograd of the
    full-precision plain version (the straight-through rule) and its
    output against the quantized plain version."""
    from repro_torch.core.dispatch import transport
    from repro_torch.kernels.moe_fused import ops as f_ops
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                                  grouped_ffn_ragged_ref,
                                                  grouped_ffn_ref)
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import (permute_ref,
                                                     unpermute_ref)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def grads(fn, inputs, g):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        out.backward(g)
        return out.detach(), [t.grad for t in leaves]

    def compare(name, kernel_fn, plain_fn, inputs, g, atol, rtol,
                plain_out=None):
        """``plain_out``: the forward's plain version when it is not
        ``plain_fn`` (K7)."""
        out_k, g_k = grads(kernel_fn, inputs, g)
        out_p, g_p = grads(plain_fn, inputs, g)
        if plain_out is not None:
            out_p = plain_out(*inputs)
        torch.cuda.synchronize()
        errs = []
        for a, b in zip([out_k] + g_k, [out_p] + g_p):
            ok, err = close(torch, a, b, atol + rtol * float(b.abs().max()),
                            0.0)
            if not ok:
                raise SystemExit(f"{name} backward: kernel Function and "
                                 f"plain autograd disagree (max abs err "
                                 f"{err})")
            errs.append(err)
        return {"max_abs_err": max(errs), "atol": atol, "rtol": rtol}

    T, S, K, d, f, E = 64, 100, 2, 128, 128, 3
    out = {}
    tok = randint(T + 1, (S,))
    out["K1"] = compare(
        "K1", lambda x: p_ops.permute(x, tok, use_pallas=True),
        lambda x: permute_ref(x, tok), [randn(T, d)], randn(S, d),
        BWD_F32_ATOL, BWD_F32_RTOL)
    inv_idx = randint(S + 1, (T, K))
    inv_w = torch.where(inv_idx < S, randn(T, K).abs(), 0.0)
    out["K2"] = compare(
        "K2", lambda y, w: p_ops.unpermute(y, inv_idx, w, use_pallas=True),
        lambda y, w: unpermute_ref(y, inv_idx, w), [randn(S, d), inv_w],
        randn(T, d), BWD_F32_ATOL, BWD_F32_RTOL)
    T22, di = layout22
    S22, d22 = di.num_slots, 1024
    tok22 = di.slot_to_token
    out["K1_2x2"] = compare(
        "K1 (2x2 layout)", lambda x: p_ops.permute(x, tok22, use_pallas=True),
        lambda x: permute_ref(x, tok22), [randn(T22, d22)],
        randn(S22, d22), BWD_F32_ATOL, BWD_F32_RTOL)
    out["K1_2x2"]["sentinel_slots"] = int((tok22 >= T22).sum())
    out["K2_2x2"] = compare(
        "K2 (2x2 layout)",
        lambda y, w: p_ops.unpermute(y, di.inv_idx, w, use_pallas=True),
        lambda y, w: unpermute_ref(y, di.inv_idx, w),
        [randn(S22, d22), di.inv_w], randn(T22, d22), BWD_F32_ATOL,
        BWD_F32_RTOL)
    out["K2_2x2"]["dropped_picks"] = int((di.inv_idx >= S22).sum())
    segs, exps = transport.stage_segments(E, ((2, 24), (4, 8)))
    widths = torch.as_tensor(segs[1:], device="cuda") - torch.as_tensor(
        segs[:-1], device="cuda")
    valid = (torch.rand(len(exps), generator=gen, device="cuda")
             * (widths + 1)).to(torch.int32)
    R = segs[-1]
    w3 = [randn(E, d, f, dtype=torch.bfloat16, scale=d ** -0.5),
          randn(E, f, d, dtype=torch.bfloat16, scale=f ** -0.5)]
    out["K3"] = compare(
        "K3", lambda x, wi, wo: g_ops.grouped_ffn_ragged(
            x, segs, exps, valid, wi, None, wo, activation="gelu",
            use_pallas=True),
        lambda x, wi, wo: grouped_ffn_ragged_ref(
            x, segs, exps, valid, wi, None, wo, activation="gelu"),
        [randn(R, d, dtype=torch.bfloat16)] + w3,
        randn(R, d, dtype=torch.bfloat16), BWD_BF16_ATOL, BWD_BF16_RTOL)
    # K7 on the same layout, with zero rows past each segment's valid count
    # (the zero-slot convention its per-segment scales rely on)
    x7 = randn(R, d, dtype=torch.bfloat16)
    x7[dead_rows(torch, segs, valid, R)] = 0
    out["K7"] = compare(
        "K7", lambda x, wi, wo: g_ops.grouped_ffn_ragged_quant(
            x, segs, exps, valid, wi, None, wo, activation="gelu",
            use_pallas=True),
        lambda x, wi, wo: grouped_ffn_ragged_ref(
            x, segs, exps, valid, wi, None, wo, activation="gelu"),
        [x7] + w3, randn(R, d, dtype=torch.bfloat16), BWD_BF16_ATOL,
        BWD_BF16_RTOL,
        plain_out=lambda x, wi, wo: grouped_ffn_ragged_quant_ref(
            x, segs, exps, valid, wi, None, wo, activation="gelu"))
    # K6 on an [E, 40, d] buffer: one 64-row tile an expert, masked at 40
    xg = randn(E, 40, d, dtype=torch.bfloat16)
    out["K6"] = compare(
        "K6", lambda x, wi, wo: g_ops.grouped_ffn(x, wi, None, wo,
                                                  activation="gelu"),
        lambda x, wi, wo: grouped_ffn_ref(x, wi, None, wo,
                                          activation="gelu"),
        [xg] + w3, randn(E, 40, d, dtype=torch.bfloat16), BWD_BF16_ATOL,
        BWD_BF16_RTOL)
    # K4 at the a2a layout's occupancy: each expert's segment holds a
    # random number of realized rows with a gate weight each, then
    # sentinel slots (token T, weight 0)
    s_valid = (torch.rand(E, generator=gen, device="cuda")
               * (T + 1)).to(torch.int32)
    row = torch.arange(T, device="cuda", dtype=torch.int32)
    s_tok = torch.where(row[None, :] < s_valid[:, None], row[None, :],
                        T).reshape(-1).to(torch.int32)
    s_w = torch.where(s_tok < T, torch.rand(E * T, generator=gen,
                                            device="cuda"), 0.0)
    offs = transport.expert_segments(E, T)
    out["K4"] = compare(
        "K4", lambda x, w, wi, wo: f_ops.local_moe(
            x, s_tok, w, offs, tuple(range(E)), s_valid, wi, None, wo,
            activation="gelu", use_pallas=True),
        lambda x, w, wi, wo: local_moe_ref(
            x, s_tok, w, offs, tuple(range(E)), s_valid, wi, None, wo,
            activation="gelu"),
        [randn(T, d, dtype=torch.bfloat16), s_w] + w3, randn(T, d),
        BWD_BF16_ATOL, BWD_BF16_RTOL)
    return out


def train_phase(world, out_path: str, global_batch: int,
                dispatch: str = "a2a", wire_codec: str = "",
                steps: int = TRAIN_STEPS, aux_mode: str = "ta",
                use_moe_kernel: bool = False) -> None:
    """Full-width gpt3_medium_moe on this rank (``world`` None: one rank),
    AdamW, ``steps`` steps, the given dispatch path, wire codec and
    auxiliary loss (the pipelined path's chunk count from the overlap
    model); writes this rank's report to ``out_path``.  The run goes
    through ``trainer.train``, or, with ``use_moe_kernel`` (the dense
    grouped FFN kernel, which ``trainer.train`` does not take, as the
    reference's does not), through ``build_ctx(use_moe_kernel=True)`` and
    ``trainer.make_train_step`` on the batches ``trainer.train`` builds.

    Before the run, the plain path computes the first step's loss from the
    same initial parameters and batch, with the kernels switched off by
    ``use_pallas=False`` and by the backend's ``REPRO_TORCH_KERNELS=0``
    (``grouped_ffn`` reads only the latter, as the reference's entry
    ignores ``use_pallas``).  The launch counters are set to 0 just before
    the run and read just after.  One more step on the trained state runs
    under torch.profiler (not counted)."""
    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_config(ARCH_ID)
    run = RunConfig(seq_len=TRAIN_SEQ, global_batch=global_batch,
                    warmup_steps=1, aux_mode=aux_mode, dispatch=dispatch,
                    a2a_num_chunks=0, wire_codec=wire_codec, seed=0)
    rank = 0 if world is None else world.rank

    def ctx_for(use_pallas):
        return model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                                   global_batch=global_batch,
                                   aux_mode=run.aux_mode,
                                   dispatch=run.dispatch,
                                   a2a_num_chunks=run.a2a_num_chunks,
                                   wire_codec=run.wire_codec,
                                   use_pallas=use_pallas,
                                   use_moe_kernel=use_moe_kernel,
                                   device="cuda")

    plain_ctx = ctx_for(False)
    params = model_lib.init_params(
        plain_ctx, torch.Generator(device="cuda").manual_seed(run.seed))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=global_batch, seed=run.seed))
    backend.reset_launches()
    os.environ[backend.ENV_VAR] = "0"
    with torch.no_grad():
        _, m = transformer.loss_fn(params, shard_batch(data.batch(0), world,
                                                       "cuda"),
                                   plain_ctx, aux_weight=run.aux_weight)
        plain_loss = float(trainer.world_mean_metrics(m, world)["loss"])
    del os.environ[backend.ENV_VAR]
    plain_launches = dict(backend.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    kernel_ctx = ctx_for(None)
    if use_moe_kernel:
        res = steps_through(torch, kernel_ctx, run, params, data, steps)
    else:
        res = trainer.train(arch, run, world, steps=steps, log_every=1,
                            verbose=rank == 0, params=params, device="cuda")
    launches = dict(backend.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    step = trainer.make_train_step(kernel_ctx, run)
    batch = shard_batch(data.batch(steps), world, "cuda")
    profiled = profile_train_step(torch, step, res.params, res.opt_state,
                                  batch)
    spare_row = None
    if world is not None and dispatch == "a2a":
        # the same step once more with the earlier spare-row backwards,
        # for the backward scatters' device time before and after
        spare = spare_row_backwards(torch)
        shipped = {fn: fn.backward for fn in spare}
        for fn, bwd in spare.items():
            fn.backward = staticmethod(bwd)
        try:
            spare_row = profile_train_step(torch, step, res.params,
                                           res.opt_state, batch)
        finally:
            for fn, bwd in shipped.items():
                fn.backward = staticmethod(bwd)
    hist = res.metrics_history
    report = {
        "rank": rank, "coords": None if world is None else list(world.coords),
        "a2a_num_chunks": plain_ctx.a2a_num_chunks,
        "caps": list(plain_ctx.plan.caps), "losses": res.losses,
        "nll": [h["nll"] for h in hist], "aux": [h["aux"] for h in hist],
        "frac_by_level": [h.get("frac_by_level") for h in hist],
        "dropped": [h.get("dropped") for h in hist],
        "grad_norm": [h["grad_norm"] for h in hist],
        "plain_first_loss": plain_loss, "plain_launches": plain_launches,
        "step_wall_s": res.step_seconds, "launches": launches,
        "max_memory_allocated_gb": peak_gb, "profiled_step": profiled,
        "profiled_step_spare_row_backwards": spare_row}
    with open(out_path, "w") as fh:
        json.dump(report, fh)


def steps_through(torch, ctx, run, params, data, steps: int):
    """``trainer.train``'s loop on one rank from a context it does not
    build: the same optimizer state, batches, step timing and metrics."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    opt_state = adamw.init_state(params)
    step = trainer.make_train_step(ctx, run)
    losses, history, step_s = [], [], []
    for i in range(steps):
        batch = shard_batch(data.batch(i), None, "cuda")
        ts = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        h = {k: float(v) if v.dim() == 0 else [float(x) for x in v]
             for k, v in metrics.items()}
        losses.append(h["loss"])
        history.append(h)
        print(f"step {i:5d} loss {h['loss']:.4f} nll {h['nll']:.4f} aux "
              f"{h['aux']:.4f} dropped {h['dropped']:.4f}", flush=True)
    return trainer.TrainResult(losses=losses, metrics_history=history,
                               steps_per_sec=steps / sum(step_s),
                               params=params, opt_state=opt_state,
                               step_seconds=step_s)


def profile_train_step(torch, step, params, opt_state, batch) -> dict:
    """One more training step under torch.profiler (not counted): wall
    and device time, busy share, launches, the top kernels, and the device
    time of the kernels launched inside each backward's profiler range
    (BACKWARD_RANGES: K1's and K2's scatters apart from the ragged FFN's
    weight scatters)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # the ranges also appear as device-side spans; only kernels count
    events = [e for e in averages if e.device_type.name == "CUDA"
              and e.key not in BACKWARD_RANGES]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:60], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top],
            "backward_ranges": {
                e.key: {"count": e.count,
                        "device_ms": e.device_time_total / 1e3}
                for e in averages
                if e.key in BACKWARD_RANGES and e.device_type.name == "CPU"}}


def spare_row_backwards(torch):
    """K1's and K2's backwards as the port first had them, every sentinel
    slot (dropped pick) added into one spare row, under the ranges of the
    shipped ones: the yardstick the train_2x2 phase profiles one more
    step with.  Returns ``{Function: backward}``."""
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import _with_zero_row

    def permute_bwd(ctx, g):
        (slot_to_token,) = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGES[0]):
            gx = g.new_zeros((ctx.num_tokens + 1, g.shape[-1]))
            gx.index_add_(0, slot_to_token.long(), g)
            return gx[:ctx.num_tokens], None, None

    def unpermute_bwd(ctx, g):
        y, inv_idx, inv_w = ctx.saved_tensors
        S, d = y.shape
        with torch.profiler.record_function(BACKWARD_RANGES[1]):
            g = g.to(torch.float32)
            y_z = _with_zero_row(y)
            gy = torch.zeros((S + 1, d), dtype=torch.float32,
                             device=y.device)
            gw_cols = []
            for k in range(inv_idx.shape[1]):
                idx = inv_idx[:, k].long()
                gy.index_add_(0, idx,
                              g * inv_w[:, k].to(torch.float32)[:, None])
                picked = y_z.index_select(0, idx).to(torch.float32)
                gw_cols.append(torch.sum(g * picked, dim=-1))
            gw = torch.stack(gw_cols, dim=1).to(inv_w.dtype)
            return gy[:S].to(y.dtype), None, gw, None

    return {p_ops.Permute: permute_bwd, p_ops.Unpermute: unpermute_bwd}


def train_rank(world, out_dir: str, global_batch: int, dispatch: str = "a2a",
               wire_codec: str = "", steps: int = TRAIN_STEPS) -> None:
    train_phase(world, os.path.join(out_dir, f"rank{world.rank}.json"),
                global_batch, dispatch, wire_codec, steps)


def check_training(reports, want: dict, label: str,
                   rtol: float = LOSS_RTOL, steps: int = TRAIN_STEPS) -> dict:
    """Launch counts (none on the plain path), finite losses, agreement of
    the ranks' world means, and the kernel path's first-step loss against
    the plain path's."""
    for r in reports:
        if any(r["plain_launches"].values()):
            raise SystemExit(f"{label} rank {r['rank']}: the plain path "
                             f"launched {r['plain_launches']}")
        for name, n in want.items():
            if r["launches"][name] != n:
                raise SystemExit(f"{label} rank {r['rank']}: {name} "
                                 f"launched {r['launches'][name]} times, "
                                 f"the path needs {n}")
        if len(r["losses"]) != steps or not all(
                math.isfinite(v) for v in r["losses"]):
            raise SystemExit(f"{label} rank {r['rank']}: losses "
                             f"{r['losses']}")
        if r["losses"] != reports[0]["losses"]:
            raise SystemExit(f"{label}: ranks disagree on the world-mean "
                             f"losses")
    first, plain = reports[0]["losses"][0], reports[0]["plain_first_loss"]
    rel = abs(first - plain) / abs(plain)
    if not rel <= rtol:
        raise SystemExit(f"{label}: first-step loss {first} (kernels) vs "
                         f"{plain} (plain): relative {rel} > {rtol}")
    return {"first_loss_kernel": first, "first_loss_plain": plain,
            "rel_diff": rel, "rtol": rtol}


def overlap_terms(arch) -> dict:
    """The overlap model's inputs and verdict for the 2x2 plan under the
    int8 wire (the reference's link and peak constants)."""
    from repro_torch.core import comm_model
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model as model_lib
    world = EPWorld(axis_names=("pod", "data"), axis_sizes=WORLD_22,
                    coords=(0, 0), device="cuda")
    plan = model_lib.make_plan(arch, world, TRAIN_SEQ, TRAIN_BATCH_22, "ta")
    terms = comm_model.moe_overlap_terms(
        plan, d_model=arch.d_model, d_ff=arch.moe.d_ff_expert,
        bytes_per_el=2, activation=arch.activation, codec="int8")
    return dict(terms, chunks=comm_model.choose_num_chunks(**terms),
                caps=list(plan.caps), ratios=list(plan.ratios))


def serve_requests(rng, vocab: int, n: int):
    from repro_torch.serving.scheduler import Request
    lens = rng.integers(32, BUCKET + 1, size=n)
    budgets = rng.integers(16, 65, size=n)
    return [Request(uid=i, tokens=rng.integers(0, vocab, size=int(L)).tolist(),
                    max_new_tokens=int(m))
            for i, (L, m) in enumerate(zip(lens, budgets))]


def _cast_params(params, dtype):
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def end_to_end_check(torch, np, params, ctx):
    """The kernel path against a float32 plain reference on the card: one
    32-token prompt, prefill + 4 decode steps.  The bf16 plain path (no
    kernels) is measured against the same reference; the kernel path must
    be no further from it than E2E_RATIO times that, or E2E_FLOOR."""
    import dataclasses
    from repro_torch.serving import engine
    rng = np.random.default_rng(7)
    prompt = torch.as_tensor(rng.integers(0, ctx.arch.vocab_size,
                                          size=(1, 32)),
                             dtype=torch.int32, device="cuda")
    plain_ctx = dataclasses.replace(ctx, use_pallas=False, use_flash=False)
    f32_ctx = dataclasses.replace(
        plain_ctx, arch=dataclasses.replace(ctx.arch, dtype="float32"))
    runs = (("kernel", ctx, params), ("plain_bf16", plain_ctx, params),
            ("plain_f32", f32_ctx, _cast_params(params, torch.float32)))
    logits = {}
    for name, c, p in runs:
        prefill = engine.make_prefill(c, with_cache=True, cache_len=64)
        step = engine.make_decode_step(c)
        lg, cache = prefill(p, {"tokens": prompt})
        traj = [lg]
        tok = prompt[:, -1:]
        for _ in range(4):
            out, cache = step(p, cache, tok)
            traj.append(out[:, 0])
        logits[name] = torch.stack(traj)
        del p, cache
    ref = logits["plain_f32"]

    def rel(name):
        return float(torch.linalg.vector_norm(logits[name] - ref)
                     / torch.linalg.vector_norm(ref))

    rel_kernel, rel_plain = rel("kernel"), rel("plain_bf16")
    agree = float((logits["kernel"].argmax(-1) == ref.argmax(-1))
                  .float().mean())
    limit = max(E2E_RATIO * rel_plain, E2E_FLOOR)
    if not (math.isfinite(rel_kernel) and rel_kernel <= limit):
        raise SystemExit(f"end to end: kernel path logits are {rel_kernel} "
                         f"(relative) from the float32 reference, the plain "
                         f"bf16 path {rel_plain}; limit {limit}")
    return {"rel_err_kernel_vs_f32": rel_kernel,
            "rel_err_plain_bf16_vs_f32": rel_plain, "limit": limit,
            "argmax_agreement_kernel_vs_f32": agree}


def profile_steps(torch, params, ctx):
    """Step times (host clock around synchronized runs) and a
    torch.profiler breakdown of one prefill pack and one decode step at
    the serve phase's shapes: device busy share and the top kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import engine
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, ctx.arch.vocab_size, (PACK, BUCKET),
                           generator=gen, device="cuda", dtype=torch.int32)
    prefill = engine.make_prefill(ctx, with_cache=True, cache_len=CACHE_LEN)
    step = engine.make_decode_step(ctx)
    from repro_torch.models import decode
    cache = decode.init_cache(ctx, NUM_SLOTS, CACHE_LEN)
    for layer in cache:
        layer["mixer"]["pos"].fill_(BUCKET)
    cur = tokens[:, :1].repeat(NUM_SLOTS // PACK, 1)
    out = {}
    for name, fn in (("prefill_pack", lambda: prefill(params,
                                                      {"tokens": tokens})),
                     ("decode_step", lambda: step(params, cache, cur))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = {
            "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "device_ms": dev_ms,
            "device_busy_share": dev_ms / prof_wall_ms,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:60], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})

    # 2. build
    t0 = time.time()
    libs = backend.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in backend.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": time.time() - t0,
          "libs": {n: os.path.relpath(str(p), REPO) for n, p in libs.items()},
          "ptxas": ptxas})

    # 3. kernel checks at the serve phase's shapes
    arch = get_config(ARCH_ID)
    ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    t0 = time.time()
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": arch.name, "layers": arch.num_layers,
          "params": model_lib.count_params(params),
          "seconds": time.time() - t0})
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        k4 = {"decode": check_k4(
                  torch, *gather_k4_case(torch, params, ctx, NUM_SLOTS, gen),
                  "decode"),
              "prefill": check_k4(
                  torch, *gather_k4_case(torch, params, ctx, PACK * BUCKET,
                                         gen), "prefill")}
        k4_edges = [check_k4(torch, *gather_k4_case(torch, params, ctx, Tg,
                                                    gen, swiglu=True),
                             label, timed=False)
                    for Tg, label in ((NUM_SLOTS, "decode"), (100, "ragged"))]
        hd = arch.head_dim_
        k5 = check_k5(torch, (PACK, BUCKET, arch.num_heads, hd), gen)
        edges = [check_k5(torch, (2, 100, arch.num_heads, hd), gen,
                          timed=False),
                 check_k5(torch, (1, 77, 4, hd), gen, window=16,
                          timed=False),
                 check_k5(torch, (1, 50, 4, hd), gen, causal=False,
                          timed=False)]
        # K1 and K2 at rank 0's layouts of the 2x2 world: the staged plan
        # (train_2x2) and chunk 0 of the pipelined int8 plan
        # (train_2x2_pipelined)
        case = staged_case(torch, params, arch, gen)
        pcase = pipelined_case(torch, params, arch, gen)
        k1, k2 = {}, {}
        for label, c in (("S=4864", case), ("S=608", pcase)):
            di = c["di"]
            k1[label] = check_k1(torch, c["x"], di.slot_to_token)
            k2[label] = check_k2(torch, torch.randn(
                (di.num_slots, c["x"].shape[1]), generator=gen,
                device="cuda").to(torch.bfloat16), di)
        k1_edges = permute_edges(torch, gen)
        k2_edges = unpermute_edges(torch, gen)
        k3 = check_k3(torch, case)
        layout22 = (case["x"].shape[0], case["di"])
        del case
        k7 = check_k7(torch, pcase)
        del pcase
        k4["train_1rank"] = check_k4(
            torch, *train1_k4_case(torch, params, arch, gen), "train_1rank")
        x6, w_in6, w_out6, filled = einsum_k6_case(torch, params, arch, gen)
        k6 = check_k6(torch, x6, w_in6, None, w_out6, "einsum", filled)
        w_gate6 = (torch.randn(w_in6.shape, generator=gen, device="cuda")
                   * arch.d_model ** -0.5).to(torch.bfloat16)
        k6_edges = [check_k6(torch, x6, w_in6, w_gate6, w_out6, "swiglu",
                             timed=False),
                    check_k6(torch, x6[:, :100].contiguous(), w_in6, None,
                             w_out6, "C=100", timed=False)]
        del x6, w_gate6
        H, K = arch.num_heads, arch.num_kv_heads
        k8 = check_k8(torch, gen, DECODE_B, DECODE_L, H, K, timed=True)
        gc.collect()
        torch.cuda.empty_cache()
        k8_edges = [check_k8(torch, gen, 4, 4096, H, 4),
                    check_k8(torch, gen, 4, 8192, H, K, window=4096),
                    check_k8(torch, gen, 4, 1000, H, K,
                             lengths=[0, 1, 537, 1000])]
    emit({"phase": "checks", "K4": k4, "K4_edges": k4_edges, "K5": k5,
          "K5_edges": edges, "K1": k1, "K1_edges": k1_edges, "K2": k2,
          "K2_edges": k2_edges, "K3": k3, "K7": k7,
          "K6": k6, "K6_edges": k6_edges, "K8": k8, "K8_edges": k8_edges})
    bwd = backward_checks(torch, gen, layout22)
    emit({"phase": "backward_checks", **bwd})

    # 4. serve
    with torch.no_grad():
        e2e = end_to_end_check(torch, np, params, ctx)
    emit({"phase": "end_to_end", **e2e})
    cfg = engine.ServeConfig(num_slots=NUM_SLOTS, cache_len=CACHE_LEN,
                             prefill_pack=PACK, prompt_buckets=(BUCKET,))
    eng = engine.ServingEngine(params, ctx, cfg)
    rng = np.random.default_rng(0)
    eng.run(serve_requests(rng, arch.vocab_size, 1))          # warm-up
    reqs = serve_requests(rng, arch.vocab_size, NUM_REQUESTS)
    torch.cuda.synchronize()
    backend.reset_launches()
    report = eng.run(reqs)
    launches = dict(backend.LAUNCHES)
    for s in report.streams:
        if s.evicted or len(s.generated) != s.request.max_new_tokens:
            raise SystemExit(f"request {s.request.uid}: {len(s.generated)} "
                             f"of {s.request.max_new_tokens} tokens")
        if not all(0 <= t < arch.vocab_size for t in s.generated):
            raise SystemExit(f"request {s.request.uid}: token outside the "
                             f"vocabulary")
    if len(report.streams) != NUM_REQUESTS:
        raise SystemExit(f"{len(report.streams)} of {NUM_REQUESTS} streams "
                         f"finished")
    n_moe = arch.num_layers
    want_k4 = n_moe * (report.prefill_calls + report.decode_steps)
    want_k5 = arch.num_layers * report.prefill_calls
    if launches["moe_fused.local_moe"] < want_k4:
        raise SystemExit(f"K4 launched {launches['moe_fused.local_moe']} "
                         f"times, the path needs >= {want_k4}")
    if launches["flash_attn.flash_attention"] < want_k5:
        raise SystemExit(f"K5 launched "
                         f"{launches['flash_attn.flash_attention']} times, "
                         f"the path needs >= {want_k5}")
    for name in OFF_PATH:
        if launches[name]:
            raise SystemExit(f"serve: {name} launched {launches[name]} "
                             f"times, the path needs none")
    emit({"phase": "serve", "requests": len(report.streams),
          "new_tokens": report.total_new_tokens,
          "prompt_tokens": sum(len(r.tokens) for r in reqs),
          "decode_steps": report.decode_steps,
          "prefill_packs": report.prefill_calls,
          "wall_s": report.wall_time,
          "tokens_per_s": report.tokens_per_sec,
          "launches": launches,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})

    with torch.no_grad():
        emit({"phase": "profile", **profile_steps(torch, params, ctx)})
    serve_launches = launches
    del params, eng, report
    gc.collect()
    torch.cuda.empty_cache()

    # 6. training, one rank, in a child process (it frees the card when it
    # ends); the kernels were built above, so the child only loads them
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    t0 = time.time()
    child = mp.get_context("spawn").Process(
        target=train_phase, args=(None, os.path.join(tmp, "rank0.json"),
                                  TRAIN_BATCH_1))
    child.start()
    child.join()
    if child.exitcode != 0:
        raise SystemExit(f"train_1rank: the child process failed (exit "
                         f"{child.exitcode})")
    with open(os.path.join(tmp, "rank0.json")) as fh:
        one = json.load(fh)
    n_layers = arch.num_layers
    zero = {k: 0 for k in ("moe_permute.permute", "moe_permute.unpermute",
                           "moe_gemm.grouped_ffn_ragged")}
    off = {k: 0 for k in OFF_PATH}
    check1 = check_training(
        [one], dict(zero, **off,
                    **{"moe_fused.local_moe": n_layers * TRAIN_STEPS,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_1rank")
    emit({"phase": "train_1rank", "seconds": time.time() - t0,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check1, **one})

    # 7. training, 2x2 EP world: four ranks share the card over gloo
    from repro_torch.launch import mesh
    t0 = time.time()
    mesh.spawn(train_rank, WORLD_22, "gloo", "cuda",
               args=(tmp, TRAIN_BATCH_22))
    ranks = []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    per_layer = {k: n_layers * TRAIN_STEPS for k in zero}
    check22 = check_training(
        ranks, dict(per_layer, **off,
                    **{"moe_fused.local_moe": 0,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_2x2")
    emit({"phase": "train_2x2", "seconds": time.time() - t0,
          "world": list(WORLD_22), "backend": "gloo",
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_22,
          "steps": TRAIN_STEPS, **check22, "ranks": ranks})

    # 8. training, 2x2 EP world, pipelined dispatch over the int8 wire
    t0 = time.time()
    pipe_dir = os.path.join(tmp, "pipelined")
    os.makedirs(pipe_dir)
    mesh.spawn(train_rank, WORLD_22, "gloo", "cuda",
               args=(pipe_dir, TRAIN_BATCH_22, "a2a_pipelined", "int8",
                     PIPELINED_STEPS))
    pipe = []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(pipe_dir, f"rank{r}.json")) as fh:
            pipe.append(json.load(fh))
    for r in pipe:
        if r["a2a_num_chunks"] != PIPELINED_CHUNKS:
            raise SystemExit(f"train_2x2_pipelined rank {r['rank']}: "
                             f"{r['a2a_num_chunks']} chunks, the overlap "
                             f"model gives {PIPELINED_CHUNKS}")
    per_chunk = {k: n_layers * PIPELINED_CHUNKS * PIPELINED_STEPS
                 for k in ("moe_permute.permute", "moe_permute.unpermute",
                           "moe_gemm.grouped_ffn_ragged_quant")}
    check_p = check_training(
        pipe, dict(per_chunk, **off,
                   **{"moe_gemm.grouped_ffn_ragged": 0,
                      "moe_fused.local_moe": 0}),
        "train_2x2_pipelined", LOSS_RTOL_INT8, PIPELINED_STEPS)
    emit({"phase": "train_2x2_pipelined", "seconds": time.time() - t0,
          "world": list(WORLD_22), "backend": "gloo", "wire_codec": "int8",
          "overlap_terms": overlap_terms(arch), "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_22, "steps": PIPELINED_STEPS,
          **check_p,
          "ranks": pipe})

    # 9. training through the einsum baseline with K6, in a child process
    t0 = time.time()
    child = mp.get_context("spawn").Process(
        target=train_phase, args=(None, os.path.join(tmp, "einsum.json"),
                                  TRAIN_BATCH_1, "einsum", "", TRAIN_STEPS,
                                  "lb", True))
    child.start()
    child.join()
    if child.exitcode != 0:
        raise SystemExit(f"train_einsum_k6: the child process failed (exit "
                         f"{child.exitcode})")
    with open(os.path.join(tmp, "einsum.json")) as fh:
        ein = json.load(fh)
    shutil.rmtree(tmp, ignore_errors=True)
    check_e = check_training(
        [ein], {k: (n_layers * TRAIN_STEPS if k == "moe_gemm.grouped_ffn"
                    else 0) for k in backend.LAUNCHES},
        "train_einsum_k6")
    emit({"phase": "train_einsum_k6", "seconds": time.time() - t0,
          "dispatch": "einsum", "aux_mode": "lb", "use_moe_kernel": True,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check_e, **ein})

    # 10. kernels: launches summed over every main path and rank
    def total(name):
        return sum(sum(v) if isinstance(v, list) else v
                   for v in by_path(name).values())

    def by_path(name):
        return {"serve": serve_launches[name],
                "train_1rank": one["launches"][name],
                "train_2x2": [r["launches"][name] for r in ranks],
                "train_2x2_pipelined": [r["launches"][name] for r in pipe],
                "train_einsum_k6": ein["launches"][name]}

    def pair_row(k):
        """K1's or K2's times at the staged layout (S = 4864), and every
        reading at both layouts."""
        main = k["S=4864"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "call_ms", "host_us")
        lib = ("device_ms", "call_ms", "host_us")
        return {**{n: main[n] for n in keys},
                **{f"library_{n}": main["library"][n] for n in lib},
                "layouts": {label: {**{n: r[n] for n in keys},
                                    **{f"library_{n}": r["library"][n]
                                       for n in lib}}
                            for label, r in k.items()}}

    kp = k4["prefill"]
    emit({"kernels": [
        {"name": "moe_permute.permute", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_permute.cu",
         "replaces": "src/repro/kernels/moe_permute/kernel.py:54",
         "launches": total("moe_permute.permute"),
         "launches_by_path": by_path("moe_permute.permute"),
         "max_abs_err": 0.0,
         "backward_max_abs_err": max(bwd["K1"]["max_abs_err"],
                                     bwd["K1_2x2"]["max_abs_err"]),
         **pair_row(k1)},
        {"name": "moe_permute.unpermute", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_permute.cu",
         "replaces": "src/repro/kernels/moe_permute/kernel.py:88",
         "launches": total("moe_permute.unpermute"),
         "launches_by_path": by_path("moe_permute.unpermute"),
         "max_abs_err": max(e["max_abs_err"]
                            for e in list(k2.values()) + k2_edges),
         "backward_max_abs_err": max(bwd["K2"]["max_abs_err"],
                                     bwd["K2_2x2"]["max_abs_err"]),
         **pair_row(k2)},
        {"name": "moe_gemm.grouped_ffn_ragged", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:228",
         "launches": total("moe_gemm.grouped_ffn_ragged"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn_ragged"),
         "max_abs_err": k3["max_abs_err"],
         "backward_max_abs_err": bwd["K3"]["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
        {"name": "moe_gemm.grouped_ffn_ragged_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:312",
         "launches": total("moe_gemm.grouped_ffn_ragged_quant"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn_ragged_quant"),
         "max_abs_err": k7["max_abs_err"],
         "backward_max_abs_err": bwd["K7"]["max_abs_err"],
         "ms": k7["ms"], "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None},
        {"name": "moe_fused.local_moe", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_fused.cu",
         "replaces": "src/repro/kernels/moe_fused/kernel.py:123",
         "launches": total("moe_fused.local_moe"),
         "launches_by_path": by_path("moe_fused.local_moe"),
         "max_abs_err": max(e["max_abs_err"]
                            for e in list(k4.values()) + k4_edges),
         "backward_max_abs_err": bwd["K4"]["max_abs_err"],
         "ms": kp["ms"], "plain_ms": kp["plain_ms"],
         "bound_ms": kp["bound_ms"], "bound_by": kp["bound_by"],
         "library_ms": None, "layouts": k4},
        {"name": "flash_attn.flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:65",
         "launches": total("flash_attn.flash_attention"),
         "launches_by_path": by_path("flash_attn.flash_attention"),
         "max_abs_err": max([k5["max_abs_err"]]
                            + [e["max_abs_err"] for e in edges]),
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"]},
        {"name": "moe_gemm.grouped_ffn", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:185",
         "launches": total("moe_gemm.grouped_ffn"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn"),
         "max_abs_err": max(e["max_abs_err"] for e in [k6] + k6_edges),
         "backward_max_abs_err": bwd["K6"]["max_abs_err"],
         "ms": k6["ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
         "library_ms": None, "bmm_chain_ms": k6["bmm_chain_ms"]},
        {"name": "decode_attn.decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn/kernel.py:65",
         "path": "none: no model calls it, as in the reference",
         "launches": total("decode_attn.decode_attention"),
         "launches_by_path": by_path("decode_attn.decode_attention"),
         "check_launches": sum(e["launches"] for e in [k8] + k8_edges),
         "max_abs_err": max(e["max_abs_err"] for e in [k8] + k8_edges),
         "ms": k8["ms"], "plain_ms": k8["plain_ms"],
         "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
         "library_ms": k8["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
