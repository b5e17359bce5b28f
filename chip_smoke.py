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
   128 slots, partly filled), each with the rows its FFN launches compute
   (the compacted counts) beside the weighted rows, and read by
   ``chip_ab.fused_readings`` (``device_ms``, ``call_ms``, ``host_us``);
   plus edges at Tg = 100 (a picked expert whose every weight is 0, a
   weighted sentinel slot inside a count, a segment with every slot live;
   gelu and swiglu) and swiglu at Tg = 8 and 100; its compaction launch
   (``ops.compact_slots``) bit-equal to ``ref.compact_slots`` at every one
   of those layouts; flash attention (K5) at the prefill shape
   [4, 128, 16, 64] and at [4, 512, 16, 64] (plus ragged, windowed,
   non-causal and GQA edge shapes), permute
   (K1) and unpermute (K2) on rank (0, 0)'s indices of the 2x2 training
   plan and of chunk 0 of the pipelined int8 plan (S = 4864 and 608 slots;
   plus edge cases: other element types and row widths, S = 0, all
   sentinels, dropped picks, K = 1, 4 and 40, uneven grids, refused
   rows), each also read as ``device_ms`` (the card's time only),
   ``call_ms`` (called as the training path calls it, under grad) and
   ``host_us`` (the enqueue cost) beside its library call, by
   ``chip_ab.py``'s reading functions, the ragged
   grouped FFN (K3) on rank (0, 0)'s indices of the 2x2 training plan
   (1024 tokens, caps (120, 16), 16 experts a rank; read by
   ``chip_ab.ragged_readings``) and on a ragged layout (R = 1888, a
   zero-count segment inside an expert's span; gelu and swiglu), K1, K2
   and K3 once more at that rank's layout after train_2x2_replan's
   replan (caps (128, 0): one stage, the empty one dropped) and at rank
   (0, 0, 0)'s of train_2x2x2 (512 tokens, three stages, 8 experts; read
   by ``chip_ab``'s functions too), K4 at serve_2x2's gather layouts
   (rank (0, 0)'s 16 experts over the world's 8 gathered decode tokens
   and over one gathered prefill pack of 4 x 128), and the
   int8 ragged
   grouped FFN (K7) on rank (0, 0)'s chunk 0 of the pipelined int8 plan
   (8 chunks of 15 + 2 slots, int8-encoded payload, counts through the
   chains) and on the whole staged 2x2 buffer (S = 4864), with the
   weights quantized once as the engine does and in the call, the dense
   grouped FFN (K6) at the einsum phase's [64, 128,
   1024] buffer (rows past each expert's count of a top-2 route of
   random tokens zero, whose outputs must be exact zeros; plus swiglu,
   C = 1, 64, 100 and 200 (a last tile of 8 rows), E = 1 and a C = 200
   swiglu buffer zero past random counts), and decode attention (K8)
   at B = 32 requests against a 32768-row cache (16 heads of 64, NaN in
   every row past a request's length; plus GQA, window, L = 1000 and
   length-0 edge cases), with kernel, plain, bound and library times (K1
   ``index_select``, K2 ``embedding_bag``, K5 and K8
   ``scaled_dot_product_attention``; K6 has no one-call library
   counterpart, and the cuBLAS chain bmm -> gelu -> bmm is timed beside
   it as ``bmm_chain_ms``), and every kernel's and yardstick's
   ``device_ms`` (the card's time only, ``chip_ab.device_ms``);
4. backward checks — each K1-K4, K6 and K7 ``autograd.Function`` on the
   card against autograd of its plain version (K7: of the full-precision
   plain version, its straight-through rule) at a small shape, and K1's
   and K2's at the 2x2 plan's rank-0 layout, before and after the
   replan, and at the 2x2x2 plan's;
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
7. serve_2x2 — the same model and request mix on a (pod x data) = (2, 2)
   EP world of four spawned ranks sharing the card over gloo, each with
   its 16 experts a layer, 2 of the 8 slots and one row of each pack of
   4; every MoE layer through the gather path.  Every rank must launch
   K4 once per MoE layer of every prefill pack and decode step, K5 once
   per layer of every pack and nothing else; the ranks' streams must be
   the same; on 4 prompts (one a rank) the world's kernel path must be
   as close to a one-rank float32 plain run as the one-rank bf16 plain
   path is (E2E_RATIO, E2E_FLOOR); tokens/s and each rank's prefill-pack
   and decode-step times;
8. train_1rank — in a child process, ``trainer.train`` of full-width
   gpt3_medium_moe on one rank: ``dispatch="a2a"``, ``aux_mode="ta"``,
   seq 512, batch 4, AdamW, 3 steps.  K4 must launch once per layer and
   forward (36 times), and the first step's loss must agree with the plain
   path's (kernels off) on the same weights and batch.  Then, on the
   trained state, a forward and backward with the fused cross entropy
   (``ctx.fused_xent``) and with the default loss: the losses within
   LOSS_RTOL and each one's peak device memory; then one training step
   with it (K4 12 launches, counted as ``train_1rank_fused_xent``);
9. train_2x2 — the same on a 2x2 (pod x data) EP world of four spawned
   ranks that share the card over gloo, batch 8 (1024 tokens a rank):
   every rank must launch K1, K2 and K3 36 times each and K4 never, the
   ranks must agree on the world-mean losses, and the first step's loss
   must agree with the plain path's.  Each rank profiles one more step
   twice: as shipped, and with the earlier spare-row backwards of K1 and
   K2 (``spare_row_backwards``), reporting the device time inside each
   profiler range of ``PROFILED_RANGES`` (the backwards; on the pipelined
   phase K7's forward and its weight quantization too);
10. train_2x2_pipelined — the same world through ``dispatch=
   "a2a_pipelined"`` with the int8 wire codec and the overlap model's
   chunk count (8), 2 steps: every rank must launch K1, K2 and K7 192
   times each (12 layers x 8 chunks x 2 steps) and K3 and K4 never, and
   the first step's loss must agree with the plain path's within
   LOSS_RTOL_INT8;
11. train_einsum_k6 — in a child process, full-width gpt3_medium_moe on
   one rank through the paper's einsum baseline (``dispatch="einsum"``,
   ``aux_mode="lb"``, ``build_ctx(use_moe_kernel=True)``, capacity 128)
   with ``trainer.make_train_step``: seq 512, batch 4, AdamW, 3 steps.  K6
   must launch once per layer and forward (36 times), and the first
   step's loss must agree with the plain path's (``REPRO_TORCH_KERNELS=0``:
   ``grouped_ffn_ref``) on the same weights and batch;
12. train_1rank_accum_remat — in a child process, ``trainer.train`` of
   full-width gpt3_medium_moe on one rank with batch 8 accumulated over 2
   microbatches of 4 and ``remat=True`` (every layer recomputed in the
   backward), 3 steps: K4 must launch 12 x 2 x 2 x 3 = 144 times, the
   first step's loss (the mean of the microbatches') must agree with the
   plain path's; with remat and without, one microbatch's forward reads
   the device memory it holds for the backward and one more step reads
   the peak device memory (``remat_memory``);
13. train_resilient — in a child process (``resilient_phase``): a
   1-layer full-width model under chaos with rolling checkpoints (a
   skipped NaN step, a spike rolled back past a corrupted checkpoint to
   the one before, the restored tensors bit-equal to it; save, verify
   and the rollback's restore timed), then full depth guarded against
   unguarded on the same weights (losses within LOSS_RTOL, steady step
   walls);
14. train_2x2_replan — the 2x2 world at full width and depth 2 with the
   pod axis degraded 64x: every rank must replan once, at step 2, to the
   port planner's caps with the pod level's beta at inf (last cap 0), K1,
   K2 and K3 must launch every layer of every step (after the replan too)
   and K4 never, the losses must be finite, and the first step after the
   replan must log the loss the plain path computes from the same
   parameters and batch under the replanned context (within LOSS_RTOL);
   each axis's measured alpha and beta (gloo all-to-alls) are reported;
15. train_2x2x2 — the paper's nested [[2, 2], [2, 2]] topology: eight
   ranks over (pod, node, data) sharing the card over gloo, full width,
   depth cut to 6 (TRAIN_222_LAYERS: at 12 the eight ranks run the card
   out of memory), ``a2a``, ``aux_mode="ta"``, seq 512, batch 8 (512
   tokens a rank), 3 steps: the plan's three caps > 0 and a length-3
   frac_by_level, K1, K2 and K3 18 launches on every rank and K4 none,
   the first step's world-mean loss within LOSS_RTOL of the plain path's;
16. train_dp — a (pod x data) = (3, 2) world: 6 does not divide the 64
   experts, so they span data (32 a rank) and pod is pure data
   parallelism (three replicas); depth cut to DP_LAYERS, batch 6, 3
   steps: K1-K3 every layer and step, K4 none, the first step's loss
   within LOSS_RTOL of the plain path's, and every rank's expert leaves
   bit-equal (sha256) to their replicas' on the other pods;
17. DeepSeek-V2-Lite (arXiv:2405.04434) at full width on one rank,
   after every gpt3_medium_moe tensor of this process is freed: d 2048,
   MLA (rank 512, qk 128 + 64, v 128), 64 routed experts top-6 of f 1408
   beside 2 shared, swiglu, rmsnorm, a dense first layer, vocab 102400,
   27 layers, bf16 weights from seed 0.  ``checks_dsv2_lite``: K4 at the
   serve's decode and prefill gather layouts (its compaction bit-equal),
   K1 (bit-equal), K2 and K3 at the 2x2 plan's rank-0 layout and K7 at
   chunk 0 of the pipelined int8 plan, all on layer 1's weights (the
   first MoE layer), swiglu, against their plain versions with times
   and bounds.  ``serve_dsv2_lite``: the kernel path's logits against
   the bf16 plain path's (limit from a float32 plain run that casts one
   layer at a time), then the serve phase's 8 requests: K4 exactly once
   a MoE layer (26) of every prefill pack and decode step, K5 and every
   other kernel never (MLA attends in plain PyTorch); tokens/s, peak
   memory, a profiled prefill pack and decode step.
   ``e2e_dsv2_lite_d4``: the float32 three-way verdict on the first 4
   layers (a whole float32 copy of 27 does not fit beside the bf16
   weights).  ``train_dsv2_lite_d4``: in a child process, 3 steps of
   ``trainer.train`` at depth 4, seq 512, batch 4, ``aux_mode="ta"``: K4
   9 launches, the first step's loss within LOSS_RTOL of the plain
   path's, step walls and peak memory;
18. kernels — one ``{"kernels": [...]}`` line for K1-K8, launches
   summed over the main paths (serve, every rank of serve_2x2,
   train_1rank and its fused cross entropy step, every rank of
   train_2x2 and train_2x2_pipelined, train_einsum_k6,
   train_1rank_accum_remat, train_resilient, every rank of
   train_2x2_replan, train_2x2x2 and train_dp, serve_dsv2_lite,
   train_dsv2_lite_d4), with DeepSeek-V2-Lite's readings beside
   each of K1-K4 and K7.  K8 lies on no
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
# K5: scores, softmax and output sums in f32 on both sides, but the kernel
# rounds each probability to bf16 for the tensor cores' P.V product (the
# plain version keeps it f32): a relative error of up to 2^-9 a weight,
# which averages out over the keys of a row, then one bf16 rounding of the
# output; together at most a bf16 ulp or two of |out|, which RTOL covers.
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
# train_1rank_accum_remat: one rank, full depth, batch 8 as 2 microbatches
# of 4, each layer recomputed in the backward
ACCUM_BATCH, ACCUM_MICRO = 8, 4
# train_resilient: 9 steps of a 1-layer model with a checkpoint every 2
# steps; step 2's gradients are NaN (skipped), the parameters are scaled
# 10x after step 6 (the loss spikes at 7 and 8: rolled back at 8), and the
# step-5 checkpoint is corrupted right after its save (the rollback falls
# back to step 3); then GUARD_STEPS steps at full depth per guard run
RESILIENT_STEPS, GUARD_STEPS = 9, 4
RESILIENT_CHAOS = {"nan_grad_steps": (2,), "spike_steps": (6,),
                   "corrupt_ckpt_steps": (5,)}
# train_2x2_replan: the pod axis degrades 64x from step 1; the step-2
# probe collapses the pod level (replan_every 2), 4 steps, depth 2
REPLAN_LAYERS, REPLAN_STEPS = 2, 4
REPLAN_RESILIENCE = {"replan_every": 2, "degrade_threshold": 4.0,
                     "collapse_slowdown": 64.0}
REPLAN_CHAOS = {"degraded_links": ((1, "pod", 64.0),)}
# train_2x2x2: the paper's nested [[2, 2], [2, 2]] topology, eight ranks
# sharing the card over gloo, batch 8 (512 tokens a rank).  Depth cut to 6:
# at 12 layers each rank peaks at 9.15 GB allocated (10.3 GB reserved:
# AdamW's f32 moments of its 0.5 B parameters, 4 GB, and K3's plain f32
# backward), and eight of them ran the 79 GB card out of memory on an
# H100; at 6 layers each peaks at 6.57 GB
SPEC_222 = [[2, 2], [2, 2]]
TRAIN_BATCH_222, TRAIN_222_LAYERS = 8, 6
# train_dp: a (pod x data) = (3, 2) world: 6 does not divide 64 experts, so
# the experts span data (32 a rank) and pod is pure data parallelism with
# three replicas; batch 6 (512 tokens a rank); depth cut to 2, as
# train_2x2_replan's, for memory (six ranks of 32 experts a layer) and time
WORLD_DP, TRAIN_BATCH_DP, DP_LAYERS = (3, 2), 6, 2
# serve_2x2 and the end-to-end check on it: 4 prompts of 32 tokens, one a
# rank, prefill + 4 decode steps
E2E_PROMPT, E2E_STEPS, E2E_ROWS = 32, 4, 4
# end to end after 12 bf16 layers, relative Frobenius error of the logits
# against a float32 plain run: the kernel path may be at most E2E_RATIO
# times as far from it as the plain bf16 path (both differ from float32 by
# bf16 rounding, which random-weight layers amplify), or E2E_FLOOR
E2E_RATIO, E2E_FLOOR = 1.5, 1e-2
# DeepSeek-V2-Lite (arXiv:2405.04434) at full width: d 2048, 16 MLA heads
# (rank 512, qk 128 + 64, v 128), 64 routed experts top-6 of f 1408 beside
# 2 shared, a dense first layer of f 10944, vocab 102400, 27 layers (15.5 B
# bf16 parameters, 31 GB from seed 0); the checks take layer 1's weights,
# its first MoE layer.  e2e_dsv2_lite_d4 and train_dsv2_lite_d4 cut the
# depth to 4 (the dense layer and 3 MoE layers): at 27 a float32 copy
# beside the bf16 weights (93 GB), or AdamW's float32 moments (124 GB), do
# not fit the card
DSV2_ID, DSV2_MOE_LAYER, DSV2_CUT_LAYERS = "deepseek_v2_lite_16b", 1, 4
# kernels no earlier phase may launch: K6 runs only on the einsum phase, K8
# on no path
OFF_PATH = ("moe_gemm.grouped_ffn", "decode_attn.decode_attention")
# the profiler ranges whose device time a profiled training step reports:
# the backwards written for K1 and K2, the ragged FFN's (K3's and K7's)
# backward, and K7's forward (of it the profiler credits the x
# quantization's operators, not the ctypes launches) and its weight
# quantization (once a layer forward)
PROFILED_RANGES = ("moe_permute.permute.backward",
                   "moe_permute.unpermute.backward",
                   "moe_gemm.grouped_ffn_ragged.backward",
                   "moe_gemm.grouped_ffn_ragged_quant.forward",
                   "moe_gemm.quantize_expert_weights")


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


def dev_ms(torch, fn, iters: int) -> float:
    """The card's time of one call of ``fn`` (``chip_ab.device_ms``: the
    profiler's kernel, copy and memset durations, launch gaps left out)."""
    import chip_ab
    return chip_ab.device_ms(torch, fn, iters)[0]


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOP_PER_S + int8_ops / PEAK_INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gather_k4_case(torch, params, ctx, Tg: int, gen, swiglu=False,
                   rank: int = 0, ep_world: int = 1, layer: int = 0):
    """K4's inputs at the gather path's slot layout for Tg tokens of layer
    ``layer``: one segment per expert, every row of a picked expert's
    segment valid.  With ``ep_world`` > 1 the layout is EP rank ``rank``'s
    on a world of that many: its ``E / ep_world`` experts over the ``Tg``
    tokens gathered from every rank, gated over all ``E``.  A swiglu
    model's layer brings its own gate projection; with ``swiglu`` on a
    gelu model (gpt3_medium_moe) a random one is added, to hold the
    kernel's swiglu branch too."""
    from repro_torch.core import gating
    from repro_torch.core.dispatch import routing, transport
    p = params["layers"][layer]["ffn"]
    d, E = ctx.arch.d_model, ctx.arch.moe.num_experts
    E_l = E // ep_world
    mine = slice(rank * E_l, (rank + 1) * E_l)
    x = torch.randn((Tg, d), generator=gen, device="cuda").to(torch.bfloat16)
    gate_out = gating.gate_forward(p["gate"], x, ctx.gate_cfg)
    tok, w, valid = routing.gather_slots(gate_out, rank, E_l)
    w_in, w_out = p["w_in"][mine].contiguous(), p["w_out"][mine].contiguous()
    w_gate, act = None, "gelu"
    if "w_gate" in p:
        w_gate, act = p["w_gate"][mine].contiguous(), "swiglu"
    elif swiglu:
        w_gate = (torch.randn(w_in.shape, generator=gen, device="cuda")
                  * d ** -0.5).to(torch.bfloat16)
        act = "swiglu"
    return (x, tok, w, transport.expert_segments(E_l, Tg), tuple(range(E_l)),
            valid, w_in, w_gate, w_out), act


def moe_rows(torch, params, ctx, tokens, layer: int):
    """The [B * S, d] rows that layer ``layer``'s MoE block receives on
    ``tokens`` [B, S]: the embedding, the sublayers before it, then its
    own mixer and ``norm2``, as ``transformer.forward_features`` runs
    them."""
    import dataclasses
    from repro_torch.models import layers, transformer
    subs = transformer.layer_list(ctx.arch)
    x = layers.embed_apply(params["embed"], tokens)
    zero = torch.zeros((), device=x.device)
    frac = torch.zeros((ctx.frac_levels,), device=x.device)
    for i in range(layer):
        x = transformer._apply_sublayer(params["layers"][i], x, subs[i], ctx,
                                        zero, frac, zero, layer_idx=i)[0]
    p = params["layers"][layer]
    x = transformer._apply_sublayer(p, x, dataclasses.replace(
        subs[layer], ffn=None), ctx, zero, frac, zero)[0]
    return layers.norm_apply(p["norm2"], x, ctx.arch.norm).reshape(
        -1, x.shape[-1])


def train1_k4_case(torch, params, arch, gen, layer: int = 0, x=None):
    """K4's inputs at the one-rank training layout: a real ``route`` +
    ``build_indices`` of TRAIN_SEQ * TRAIN_BATCH_1 = 2048 tokens through
    layer ``layer``'s gate on the one-rank plan (gpt3_medium_moe: caps
    (128,)), laid out by the engine's ``local_layout``: one segment an
    expert as wide as the capacity, partly filled, with sentinel slots
    past each expert's realized rows and the picks past the capacity
    dropped.  The rows are random unless ``x`` (``moe_rows`` of a training
    batch) is given.  A swiglu layer (DeepSeek's) brings its own gate
    projection."""
    from repro_torch.core.dispatch import engine as engine_lib
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.launch.mesh import unit_world
    from repro_torch.models import model as model_lib
    world = unit_world("cuda")
    ctx = model_lib.build_ctx(arch, None, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_1, aux_mode="ta",
                              dispatch="a2a", device="cuda")
    T = TRAIN_SEQ * TRAIN_BATCH_1
    p = params["layers"][layer]["ffn"]
    if x is None:
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
    w_gate = p.get("w_gate")
    return (x, li.slot_to_token, li.slot_w, offs, exps, li.rows_per_expert,
            p["w_in"], w_gate, p["w_out"]), ("gelu" if w_gate is None
                                             else "swiglu")


def check_k4(torch, args, act: str, label: str, timed=True):
    """K4 against its plain version on one layout's inputs (``args`` in
    ``local_moe``'s order).  ``computed_rows`` is the rows the kernel's FFN
    launches compute (the compacted counts' sum), beside
    ``weighted_rows`` (the rows with a nonzero combine weight) and
    ``dense_rows`` (every row below the counts).  When timed, with kernel
    (events) and plain times, and for gelu ``chip_ab.fused_readings``
    (device, call and host times under grad, the bound), for swiglu (a
    DeepSeek layer) ``ffn_readings`` as serving calls it; the bound is
    ``k4_work``'s either way."""
    import chip_ab
    from repro_torch.kernels.moe_fused import ops as fused_ops
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    x, tok, w, offs, exps, valid = args[:6]
    Tg = x.shape[0]

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
    computed = int(fused_ops.compact_slots(tok, w, offs, valid,
                                           Tg)[1].sum())
    nbytes, flops, rows = k4_work(args)
    out = {"layout": label, "Tg": Tg, "activation": act,
           "slots": tok.numel(), "segments": len(exps),
           "computed_rows": computed, **rows, "max_abs_err": err,
           "atol": K4_ATOL, "rtol": K4_RTOL}
    if not timed:
        return out
    iters = 50 if Tg <= 64 else 10
    if act == "gelu":
        out.update(chip_ab.fused_readings(
            torch, fused_ops, {"label": label, "args": args},
            chip_ab.kernel_names(REPO, "moe_fused"), time_ms, bound_ms,
            K4_ATOL, K4_RTOL))
    else:
        out.update(ffn_readings(torch, kernel, "moe_fused", nbytes, flops,
                                iters))
    out.update(ms=time_ms(torch, kernel, iters),
               plain_ms=time_ms(torch, plain, max(3, iters // 5)),
               library_ms=None)
    return out


def k4_work(args):
    """K4's ``(bytes, operations, rows)`` on one layout (``args`` in
    ``local_moe``'s order): the tokens, the slot maps and counts, the
    [T, d] f32 output and the weights of the experts that hold valid rows
    (two matrices, three with a gate projection), and the operations of
    the rows with a nonzero combine weight (the work the output needs);
    ``rows`` counts those, the rows below the counts (what a dense tiling
    computes) and the active experts.  For gelu the bound equals
    ``chip_ab.fused_bound``'s."""
    x, tok, w, offs, exps, valid, w_in, w_gate, _ = args
    T, d = x.shape
    f = w_in.shape[2]
    mats = 2 if w_gate is None else 3
    weighted = int((w != 0).sum())
    active = len({e for e, v in zip(exps, valid.tolist()) if v > 0})
    nbytes = (T * d * 2 + tok.numel() * 4 + w.numel() * 4 + len(exps) * 4
              + active * mats * d * f * 2 + T * d * 4)
    return nbytes, 2.0 * weighted * mats * d * f, {
        "weighted_rows": weighted, "dense_rows": int(valid.sum()),
        "active_experts": active}


def ffn_readings(torch, kernel, source: str, nbytes: float, flops: float,
                 iters: int, int8_ops: float = 0.0) -> dict:
    """``device_ms`` of one call of ``kernel`` (``chip_ab.device_ms``),
    ``kernel_device_ms`` of its hand-written launches in
    ``csrc/<source>.cu`` alone, and the bound of ``nbytes`` and
    ``flops`` (``int8_ops``)."""
    import chip_ab
    dev, by_key = chip_ab.device_ms(torch, kernel, iters)
    b_ms, b_by = bound_ms(nbytes, flops, int8_ops)
    return {"device_ms": dev,
            "kernel_device_ms": chip_ab.ours_ms(
                by_key, chip_ab.kernel_names(REPO, source)),
            "bound_ms": b_ms, "bound_by": b_by}


def k4_edge_case(torch, params, ctx, gen, swiglu=False):
    """The gather layout at Tg = 100 (not a multiple of 64) with three
    edges planted: a picked expert whose every combine weight is 0, a
    sentinel slot with a nonzero weight inside its segment's count, and a
    segment whose every slot carries a weight (100 live rows: two tiles)."""
    args, act = gather_k4_case(torch, params, ctx, 100, gen, swiglu)
    x, tok, w, offs, exps, valid, w_in, w_gate, w_out = args
    Tg = x.shape[0]
    tok, w, valid = tok.clone(), w.clone(), valid.clone()
    picked = [e for e, v in enumerate(valid.tolist()) if v > 0]
    if len(picked) < 3:
        raise SystemExit(f"K4 edges: {len(picked)} experts picked of "
                         f"{len(exps)}, 3 needed")
    zero_e, sent_e, full_e = picked[:3]
    w[offs[zero_e]:offs[zero_e + 1]] = 0
    tok[offs[sent_e] + 3] = Tg
    w[offs[sent_e] + 3] = 0.7
    w[offs[full_e]:offs[full_e + 1]] = 0.1 + 0.9 * torch.rand(
        Tg, generator=gen, device="cuda")
    return (x, tok, w, offs, exps, valid, w_in, w_gate, w_out), act


def check_compaction(torch, args, label: str):
    """K4's compaction launch alone (``ops.compact_slots``) bit-equal to
    its plain mirror on one layout."""
    from repro_torch.kernels.moe_fused import ops as fused_ops
    from repro_torch.kernels.moe_fused import ref as fused_ref
    x, tok, w, offs, exps, valid = args[:6]
    T = x.shape[0]
    live, count = fused_ops.compact_slots(tok, w, offs, valid, T,
                                          use_pallas=True)
    want_live, want_count = fused_ref.compact_slots(tok, w, offs, valid, T)
    torch.cuda.synchronize()
    if not (torch.equal(live, want_live) and torch.equal(count, want_count)):
        bad = int((live != want_live).sum()) + int(
            (count != want_count).sum())
        raise SystemExit(f"compact_slots {label}: kernel differs from plain "
                         f"in {bad} entries")
    return {"layout": label, "slots": tok.numel(),
            "live_rows": int(count.sum()),
            "live_segments": int((count > 0).sum())}


def check_k5(torch, shape, gen, causal=True, window=0, timed=True,
             kv_heads=None):
    """K5 against its plain version on random bf16 q [B, S, H, hd] and k, v
    [B, S, kv_heads (default H), hd]; when timed, with kernel, plain, bound
    and ``scaled_dot_product_attention`` times (events), and the kernel's
    and SDPA's ``device_ms``."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    F = torch.nn.functional
    B, S, H, hd = shape
    kv_shape = (B, S, kv_heads or H, hd)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda")
               .to(torch.bfloat16) for sh in (shape, kv_shape, kv_shape))

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
        raise SystemExit(f"K5 {shape} kv_heads={kv_heads} causal={causal} "
                         f"window={window}: kernel disagrees with plain "
                         f"(max abs err {err})")
    out = {"shape": list(shape), "kv_heads": kv_heads or H, "causal": causal,
           "window": window, "max_abs_err": err, "atol": K5_ATOL,
           "rtol": K5_RTOL}
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
               device_ms=dev_ms(torch, kernel, 100),
               plain_ms=time_ms(torch, plain, 20),
               library_ms=time_ms(torch, library, 100),
               library_device_ms=dev_ms(torch, library, 100),
               bound_ms=b_ms, bound_by=b_by)
    return out


def staged_case(torch, params, arch, gen, slowdowns=None, sizes=WORLD_22,
                global_batch=TRAIN_BATCH_22, layer: int = 0):
    """Rank (0, 0)'s view of the 2x2 training phase's plan: a real
    ``route`` + ``build_indices`` of 1024 random tokens through layer 0's
    gate, the 2x2 EP spec and its Eq. (7) plan (caps (120, 16)).  The
    rank's send buffer, read back through an identity exchange, stands in
    for the receive buffer of the ragged grouped FFN (K3).  With
    ``slowdowns`` (per-axis link slowdowns) the plan is the one
    ``RecoveryPolicy.replan`` gives under ``REPLAN_RESILIENCE``: the
    train_2x2_replan phase's layout after its replan (caps (128, 0): the
    empty second stage is dropped).  ``sizes`` and ``global_batch`` name
    another world's: (2, 2, 2) and 8 give rank (0, 0, 0)'s view of
    train_2x2x2 (512 tokens, three stages, 8 experts a rank).  ``layer``
    names another layer's gate and weights (a DeepSeek model's first MoE
    layer is 1); ``w_gate`` is the rank's gate projection, None for a gelu
    model."""
    from repro_torch.core.capacity import default_axis_names
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.kernels.moe_permute.ref import permute_ref
    from repro_torch.launch.mesh import EPWorld
    from repro_torch.models import model as model_lib
    from repro_torch.resilience import ResilienceConfig
    from repro_torch.resilience.policy import RecoveryPolicy
    world = EPWorld(axis_names=default_axis_names(len(sizes)),
                    axis_sizes=tuple(sizes), coords=(0,) * len(sizes),
                    device="cuda")
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=global_batch, aux_mode="ta",
                              device="cuda")
    if slowdowns is not None:
        ctx = RecoveryPolicy(ResilienceConfig(**REPLAN_RESILIENCE)).replan(
            ctx, slowdowns)
    T = TRAIN_SEQ * global_batch // world.size
    d = arch.d_model
    p = params["layers"][layer]["ffn"]
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
            "w_gate": (p["w_gate"][:E_l].contiguous() if "w_gate" in p
                       else None),
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
    """K3 ragged grouped FFN on a staged receive layout (the 2x2 phase's:
    16 experts, 96 segments of width 120 or 16, tanh-gelu), with the
    activation the case's layer has: swiglu where it carries a gate
    projection (a DeepSeek layer).  Gelu is read by
    ``chip_ab.ragged_readings`` (device, call and host times under grad,
    ``kernel_device_ms`` its launch pair alone, the bound); swiglu is held
    here, rows past each segment's count exact zeros, and read by
    ``ffn_readings`` (the bound with the gate's weights and products)."""
    import chip_ab
    from repro_torch.kernels.moe_fused.ops import plan_expert_tiles
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    w_in, w_gate, w_out = case["w_in"], case["w_gate"], case["w_out"]
    act = "gelu" if w_gate is None else "swiglu"

    def kernel():
        return g_ops.grouped_ffn_ragged(xin, segs, exps, valid, w_in, w_gate,
                                        w_out, activation=act,
                                        use_pallas=True)

    def plain():
        return grouped_ffn_ragged_ref(xin, segs, exps, valid, w_in, w_gate,
                                      w_out, activation=act)

    active = len({e for e, v in zip(exps, valid.tolist()) if v > 0})
    if w_gate is None:
        r = chip_ab.ragged_readings(torch, g_ops, case,
                                    chip_ab.kernel_names(REPO, "moe_gemm"),
                                    time_ms, bound_ms, K3_ATOL, K3_RTOL)
    else:
        R, d = xin.shape
        f = w_in.shape[2]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K3_ATOL, K3_RTOL)
        zeros_exact = bool((got[dead_rows(torch, segs, valid, R)]
                            == 0).all())
        if not ok or not zeros_exact:
            raise SystemExit(f"K3 {act} at R={R}: kernel disagrees with "
                             f"plain (max abs err {err}, rows past nvalid "
                             f"zero: {zeros_exact})")
        nvalid = int(valid.sum())
        r = {"R": R, "valid_rows": nvalid, "max_abs_err": err,
             **ffn_readings(torch, kernel, "moe_gemm",
                            nvalid * d * 2 + active * 3 * d * f * 2
                            + R * d * 2 + valid.numel() * 4,
                            2.0 * nvalid * 3 * d * f, 20)}
    widths = {b - a for a, b in zip(segs[:-1], segs[1:])}
    return {**r, "segments": len(exps), "experts": w_in.shape[0],
            "activation": act, "segment_widths": sorted(widths),
            "active_experts": active,
            "tiles": len(plan_expert_tiles(tuple(segs), tuple(exps))),
            "atol": K3_ATOL, "rtol": K3_RTOL,
            "ms": time_ms(torch, kernel, 20),
            "plain_ms": time_ms(torch, plain, 5), "library_ms": None}


def k3_edges(torch, case, gen):
    """K3 against its plain version on a ragged layout of the rank's 16
    experts: stages (2, 45) and (4, 7), so each expert's span is 118 rows
    (two tiles, the second crossing segments) and R = 1888 is not a
    multiple of 64; random counts, and a zero-count segment inside expert
    0's span (its second); gelu and swiglu."""
    from repro_torch.core.dispatch import transport
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    w_in, w_out = case["w_in"], case["w_out"]
    E_l, d, f = w_in.shape
    segs, exps = transport.stage_segments(E_l, ((2, 45), (4, 7)))
    if not exps[0] == exps[1] == exps[2]:
        raise SystemExit(f"K3 edges: segment 1 is not inside expert "
                         f"{exps[0]}'s span")
    R = segs[-1]
    widths = torch.as_tensor(segs[1:], device="cuda") - torch.as_tensor(
        segs[:-1], device="cuda")
    valid = (torch.rand(len(exps), generator=gen, device="cuda")
             * (widths + 1)).to(torch.int32)
    valid[1] = 0
    valid[0] = widths[0]
    xin = torch.randn((R, d), generator=gen, device="cuda").to(torch.bfloat16)
    w_gate = (torch.randn(w_in.shape, generator=gen, device="cuda")
              * d ** -0.5).to(torch.bfloat16)
    dead = dead_rows(torch, segs, valid, R)
    out = []
    for act, wg in (("gelu", None), ("swiglu", w_gate)):
        got = g_ops.grouped_ffn_ragged(xin, segs, exps, valid, w_in, wg,
                                       w_out, activation=act,
                                       use_pallas=True)
        want = grouped_ffn_ragged_ref(xin, segs, exps, valid, w_in, wg,
                                      w_out, activation=act)
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K3_ATOL, K3_RTOL)
        zeros_exact = bool((got[dead] == 0).all())
        if not ok or not zeros_exact:
            raise SystemExit(f"K3 edges, {act}: kernel disagrees with plain "
                             f"(max abs err {err}, rows past nvalid zero: "
                             f"{zeros_exact})")
        out.append({"R": R, "segments": len(exps), "activation": act,
                    "valid_rows": int(valid.sum()), "max_abs_err": err})
    return out


def layout_checks(torch, case, gen):
    """K1, K2 and K3 against their plain versions at one ``staged_case``
    layout (train_2x2_replan's after its replan: the pod axis 64x slower,
    caps (128, 0), so ``plan_stages`` keeps one stage and every slot of a
    rank's send buffer stays in its pod; train_2x2x2's: three stages): K1
    bit-equal, K2 within K2_ATOL + K2_RTOL·|plain| on random bf16 slot
    rows, K3 within K3_ATOL + K3_RTOL·|plain| on the receive buffer, with
    every row past a segment's valid count exactly 0."""
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import permute_ref, unpermute_ref
    x, di = case["x"], case["di"]
    tok = di.slot_to_token
    k1 = p_ops.permute(x, tok, use_pallas=True)
    k1_ok = torch.equal(k1, permute_ref(x, tok))
    y = torch.randn((di.num_slots, x.shape[1]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k2_ok, k2_err = close(
        torch, p_ops.unpermute(y, di.inv_idx, di.inv_w, use_pallas=True),
        unpermute_ref(y, di.inv_idx, di.inv_w), K2_ATOL, K2_RTOL)
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    got = g_ops.grouped_ffn_ragged(xin, segs, exps, valid, case["w_in"],
                                   None, case["w_out"], activation="gelu",
                                   use_pallas=True)
    want = grouped_ffn_ragged_ref(xin, segs, exps, valid, case["w_in"], None,
                                  case["w_out"], activation="gelu")
    torch.cuda.synchronize()
    k3_ok, k3_err = close(torch, got, want, K3_ATOL, K3_RTOL)
    zeros_exact = bool((got[dead_rows(torch, segs, valid, xin.shape[0])]
                        == 0).all())
    if not (k1_ok and k2_ok and k3_ok and zeros_exact):
        raise SystemExit(f"caps {case['caps']}: K1 bit-equal {k1_ok}, K2 "
                         f"max abs err {k2_err}, K3 max abs err {k3_err}, "
                         f"K3 rows past nvalid zero {zeros_exact}")
    return {"caps": list(case["caps"]), "S": di.num_slots,
            "sentinel_slots": int((tok >= x.shape[0]).sum()),
            "R": xin.shape[0], "segments": len(exps),
            "valid_rows": int(valid.sum()),
            "K1_max_abs_err": 0.0, "K2_max_abs_err": k2_err,
            "K3_max_abs_err": k3_err, "K2_atol": K2_ATOL,
            "K2_rtol": K2_RTOL, "K3_atol": K3_ATOL, "K3_rtol": K3_RTOL}


def pipelined_case(torch, params, arch, gen, layer: int = 0,
                   chunks=PIPELINED_CHUNKS):
    """Rank (0, 0)'s view of chunk 0 of the train_2x2_pipelined phase: a
    real ``route`` + ``build_indices`` of 1024 random tokens through layer
    0's gate on the 2x2 EP spec and the int8 wire's chunk-aligned plan
    (caps (120, 16), 8 chunks: 15 and 2 slots of the two stages a chunk),
    the payload int8-encoded and decoded and the valid-row counts moved
    through the transport's chains, as the engine does.  An identity
    exchange stands in for the all-to-alls: the rank's send buffer is the
    receive buffer of the int8 ragged grouped FFN (K7).  ``layer`` as
    ``staged_case``'s; ``chunks`` None takes the overlap model's count
    whatever it is."""
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
    if chunks is not None and k != chunks:
        raise SystemExit(f"pipelined plan: {k} chunks, expected {chunks}")
    T = TRAIN_SEQ * TRAIN_BATCH_22 // world.size
    d = arch.d_model
    p = params["layers"][layer]["ffn"]
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
            "w_gate": (p["w_gate"][:E_l].contiguous() if "w_gate" in p
                       else None),
            "w_out": p["w_out"][:E_l].contiguous()}


def dead_rows(torch, segs, valid, R):
    """[R] bool: the rows at or past their segment's valid count."""
    offs = torch.as_tensor(segs, device="cuda")
    rows = torch.arange(R, device="cuda")
    seg_of = torch.searchsorted(offs[1:], rows, right=True)
    return (rows - offs[seg_of]) >= valid[seg_of].long()


def check_k7(torch, case):
    """K7 on one layout of the pipelined int8 plan's rank (0, 0) (chunk 0,
    S = 608, or the whole staged buffer, S = 4864, whose expert spans of
    304 rows cross 64-row tiles) against its plain version on the same
    segments (so the same per-segment and per-expert scales): called as
    the dispatch engine calls it, with the weights quantized once
    (``quantize_expert_weights``), and with them quantized in the call;
    rows past each segment's count must be exact zeros.  The activation
    is the case's layer's: swiglu where it carries a gate projection (a
    DeepSeek layer), whose weights are quantized beside ``w_in``.  With
    kernel (events and ``device_ms``; ``kernel_device_ms`` the launch pair
    alone), plain and bound times, and the times of the quantizations:
    ``quantize_ms`` (x, each call) and ``weights_quantize_ms`` (the
    weights, once a layer forward)."""
    import chip_ab
    from repro_torch.kernels.moe_fused.ops import plan_expert_tiles
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_ragged_quant_ref,
                                                  quantize_segments)
    xin, valid = case["xin"], case["rows_valid"]
    segs, exps = case["segs"], case["exps"]
    w_in, w_gate, w_out = case["w_in"], case["w_gate"], case["w_out"]
    act = "gelu" if w_gate is None else "swiglu"
    qw = g_ops.quantize_expert_weights(w_in, w_gate)

    def kernel(qweights=qw):
        return g_ops.grouped_ffn_ragged_quant(xin, segs, exps, valid, w_in,
                                              w_gate, w_out, activation=act,
                                              use_pallas=True,
                                              qweights=qweights)

    def plain():
        return grouped_ffn_ragged_quant_ref(xin, segs, exps, valid, w_in,
                                            w_gate, w_out, activation=act)

    R, d = xin.shape
    f = w_in.shape[2]
    want = plain()
    dead = dead_rows(torch, segs, valid, R)
    errs = []
    for label, got in (("weights quantized once", kernel()),
                       ("weights quantized in the call", kernel(None))):
        torch.cuda.synchronize()
        ok, err = close(torch, got, want, K7_ATOL, K7_RTOL)
        zeros_exact = bool((got[dead] == 0).all())
        if not ok or not zeros_exact:
            raise SystemExit(f"K7 at S={R}, {label}: kernel disagrees with "
                             f"plain (max abs err {err}, rows past nvalid "
                             f"zero: {zeros_exact})")
        errs.append(err)
    nvalid = int(valid.sum())
    per_expert = torch.zeros(w_in.shape[0], device="cuda").index_add_(
        0, torch.as_tensor(exps, device="cuda"), valid.float())
    active = int((per_expert > 0).sum())
    # int8 valid rows, the int8 up-projections (w_in, and w_gate for
    # swiglu) and bf16 w_out of the experts used, the bf16 [R, d] output;
    # 2df int8 operations a valid row for each up-projection and 2fd bf16
    ups = 1 if w_gate is None else 2
    nbytes = nvalid * d + active * (ups * d * f + f * d * 2) + R * d * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * nvalid * f * d,
                          int8_ops=2.0 * nvalid * ups * d * f)
    widths = {offs1 - offs0 for offs0, offs1 in zip(segs[:-1], segs[1:])}
    call_dev, by_key = chip_ab.device_ms(torch, kernel, 20)
    return {"R": R, "segments": len(exps), "experts": w_in.shape[0],
            "caps": list(case["caps"]), "chunks": case.get("chunks", 1),
            "chunk_caps": case.get("chunk_caps"),
            "segment_widths": sorted(widths), "valid_rows": nvalid,
            "active_experts": active, "activation": act,
            "tiles": len(plan_expert_tiles(tuple(segs), tuple(exps))),
            "max_abs_err": max(errs), "atol": K7_ATOL, "rtol": K7_RTOL,
            "ms": time_ms(torch, kernel, 20), "device_ms": call_dev,
            "kernel_device_ms": chip_ab.ours_ms(
                by_key, chip_ab.kernel_names(REPO, "moe_gemm")),
            "quantize_ms": time_ms(
                torch, lambda: quantize_segments(xin, segs), 20),
            "weights_quantize_ms": time_ms(
                torch, lambda: g_ops.quantize_expert_weights(w_in, w_gate),
                20),
            "weights_quantize_device_ms": dev_ms(
                torch, lambda: g_ops.quantize_expert_weights(w_in, w_gate),
                20),
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


def k6_zero_past_counts(torch, gen, E: int, C: int, d: int):
    """A random [E, C, d] bf16 buffer whose rows past each expert's count
    are zero, as the one-hot dispatch leaves them; the counts include 0,
    C, and one live row in the last 64-row tile."""
    counts = torch.randint(0, C + 1, (E,), generator=gen, device="cuda")
    counts[:3] = torch.tensor([0, C, (C - 1) // 64 * 64 + 1])
    x = torch.randn((E, C, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    x[torch.arange(C, device="cuda")[None, :] >= counts[:, None]] = 0
    return x


def check_k6(torch, x, w_in, w_gate, w_out, label: str, filled=None,
             timed=True):
    """K6 (``grouped_ffn``, which launches the kernel for CUDA tensors)
    against its plain version, and every all-zero row of ``x`` to an exact
    zero row (gelu(0) = silu(0) * 0 = 0); when timed, with kernel, plain
    and bound times and the cuBLAS chain bmm -> gelu -> bmm on the same
    inputs."""
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
    zero = (x == 0).all(-1)
    if not ok or not bool((got[zero] == 0).all()):
        raise SystemExit(f"K6 {label}: kernel disagrees with plain (max abs "
                         f"err {err}) or a zero row is not zero")
    out = {"layout": label, "shape": [E, C, d], "f": f, "activation": act,
           "max_abs_err": err, "atol": K6_ATOL, "rtol": K6_RTOL,
           "zero_rows": int(zero.sum())}
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
               device_ms=dev_ms(torch, kernel, 20),
               plain_ms=time_ms(torch, plain, 5), library_ms=None,
               bmm_chain_ms=time_ms(torch, bmm_chain, 20),
               bmm_chain_device_ms=dev_ms(torch, bmm_chain, 20),
               bmm_chain_max_abs_err=chain_err, bound_ms=b_ms, bound_by=b_by)
    return out


def check_k6_edges(torch, x, w_in, w_out, gen):
    """K6 at the edges of its tiling, untimed, on the einsum case's buffer
    ``x`` [E, C, d] and weights: swiglu (a random gate projection), C = 1,
    64, 65 and 100 (the buffer's first rows), C = 200 (a last tile of 8
    rows), E = 1, and a C = 200 swiglu buffer zero past random counts."""
    E, _, d = x.shape
    w_gate = (torch.randn(w_in.shape, generator=gen, device="cuda")
              * d ** -0.5).to(torch.bfloat16)
    out = [check_k6(torch, x, w_in, w_gate, w_out, "swiglu", timed=False)]
    for c in (1, 64, 65, 100):
        out.append(check_k6(torch, x[:, :c].contiguous(), w_in, None, w_out,
                            f"C={c}", timed=False))
    return out + [
        check_k6(torch, torch.randn((E, 200, d), generator=gen,
                                    device="cuda").to(torch.bfloat16),
                 w_in, None, w_out, "C=200", timed=False),
        check_k6(torch, x[:1], w_in[:1], None, w_out[:1], "E=1",
                 timed=False),
        check_k6(torch, k6_zero_past_counts(torch, gen, E, 200, d), w_in,
                 w_gate, w_out, "C=200 swiglu, zero past counts",
                 timed=False)]


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
                   device_ms=dev_ms(torch, kernel, 20),
                   plain_ms=time_ms(torch, plain, 3),
                   library_ms=time_ms(torch, library, 10),
                   library_device_ms=dev_ms(torch, library, 10),
                   library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by)
        del kc, vc
    out["launches"] = backend.LAUNCHES[d_ops.KERNEL] - launches0
    return out


def backward_checks(torch, gen, layouts):
    """Each kernel's ``autograd.Function`` on the card against autograd of
    its plain version, at a small shape: K1 and K2 in float32 (their
    backwards are written by hand; also at each of ``layouts``, ``{label:
    (T, di)}`` at full width: "2x2", the 2x2 world's rank 0, a real route
    with about two thirds of the slots sentinels and a quarter of the
    picks dropped; "replan", the same rank's layout after
    train_2x2_replan's replan, caps (128, 0); "2x2x2", rank (0, 0, 0)'s of
    train_2x2x2, three stages), K3, K4,
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
    for label, (Tl, di) in layouts.items():
        tok_l = di.slot_to_token
        out[f"K1_{label}"] = compare(
            f"K1 ({label} layout)",
            lambda x: p_ops.permute(x, tok_l, use_pallas=True),
            lambda x: permute_ref(x, tok_l), [randn(Tl, 1024)],
            randn(di.num_slots, 1024), BWD_F32_ATOL, BWD_F32_RTOL)
        out[f"K1_{label}"]["sentinel_slots"] = int((tok_l >= Tl).sum())
        out[f"K2_{label}"] = compare(
            f"K2 ({label} layout)",
            lambda y, w: p_ops.unpermute(y, di.inv_idx, w, use_pallas=True),
            lambda y, w: unpermute_ref(y, di.inv_idx, w),
            [randn(di.num_slots, 1024), di.inv_w], randn(Tl, 1024),
            BWD_F32_ATOL, BWD_F32_RTOL)
        out[f"K2_{label}"]["dropped_picks"] = int(
            (di.inv_idx >= di.num_slots).sum())
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
            use_pallas=True, qweights=g_ops.quantize_expert_weights(wi)),
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
                use_moe_kernel: bool = False, microbatch: int = 0,
                remat: bool = False, layers: int = 0,
                spare_row: bool = False, fused_xent: bool = False,
                hash_experts: bool = False, arch_id: str = ARCH_ID) -> None:
    """Full-width ``arch_id`` (gpt3_medium_moe, or DeepSeek-V2-Lite for
    train_dsv2_lite_d4) on this rank (``world`` None: one rank),
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
    ignores ``use_pallas``); with ``microbatch`` it is the mean of the
    microbatches' losses, as the accumulated step logs it.  The launch
    counters are set to 0 just before the run and read just after.  One
    more step on the trained state runs under torch.profiler (not
    counted).  With ``remat``, two more steps read the peak device memory
    of a step with and without it (``remat_memory``).  ``layers`` > 0 cuts
    the depth.  With ``spare_row`` (a2a on a world) the profiled step runs
    once more with the earlier spare-row backwards.  With ``fused_xent``
    (one rank), before the profiled step, the forward and backward with
    the fused cross entropy and with the default loss on the same state
    and batch (``fused_xent_case``), then one training step with it,
    counted on its own.  With ``hash_experts`` the report carries the
    sha256 of this rank's expert leaves after the run, to hold data-
    parallel replicas to each other."""
    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_config(arch_id)
    if layers:
        import dataclasses
        arch = dataclasses.replace(arch, num_layers=layers)
    run = RunConfig(seq_len=TRAIN_SEQ, global_batch=global_batch,
                    warmup_steps=1, aux_mode=aux_mode, dispatch=dispatch,
                    a2a_num_chunks=0, wire_codec=wire_codec, seed=0,
                    microbatch=microbatch, remat=remat)
    rank = 0 if world is None else world.rank
    micro = microbatch if trainer.num_microbatches(run) > 1 else 0

    def ctx_for(use_pallas):
        return model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                                   global_batch=global_batch,
                                   aux_mode=run.aux_mode,
                                   dispatch=run.dispatch,
                                   a2a_num_chunks=run.a2a_num_chunks,
                                   wire_codec=run.wire_codec,
                                   use_pallas=use_pallas,
                                   use_moe_kernel=use_moe_kernel,
                                   remat=run.remat, device="cuda")

    plain_ctx = ctx_for(False)
    params = model_lib.init_params(
        plain_ctx, torch.Generator(device="cuda").manual_seed(run.seed))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=global_batch, seed=run.seed))
    backend.reset_launches()
    os.environ[backend.ENV_VAR] = "0"
    with torch.no_grad():
        b0 = shard_batch(data.batch(0), world, "cuda", microbatch=micro)
        n_mb = trainer.num_microbatches(run)
        per = b0["tokens"].shape[0] // n_mb
        losses = []
        for i in range(n_mb):
            _, m = transformer.loss_fn(
                params, {k: v[i * per:(i + 1) * per] for k, v in b0.items()},
                plain_ctx, aux_weight=run.aux_weight)
            losses.append(m["loss"])
        plain_loss = float(trainer.world_mean_metrics(
            {"loss": sum(losses) / n_mb}, world)["loss"])
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
    experts_sha256 = (expert_digest(torch, res.params, kernel_ctx)
                      if hash_experts else None)

    step = trainer.make_train_step(kernel_ctx, run)
    batch = shard_batch(data.batch(steps), world, "cuda", microbatch=micro)
    xent = (fused_xent_case(torch, kernel_ctx, run, res, batch)
            if fused_xent else None)
    profiled = profile_train_step(torch, step, res.params, res.opt_state,
                                  batch)
    memory = (remat_memory(torch, arch, run, res, batch) if remat
              else None)
    spare_profiled = None
    if spare_row:
        # the same step once more with the earlier spare-row backwards,
        # for the backward scatters' device time before and after
        spare = spare_row_backwards(torch)
        shipped = {fn: fn.backward for fn in spare}
        for fn, bwd in spare.items():
            fn.backward = staticmethod(bwd)
        try:
            spare_profiled = profile_train_step(torch, step, res.params,
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
        "profiled_step_spare_row_backwards": spare_profiled,
        "microbatch": microbatch, "remat": remat, "step_memory": memory,
        "layers": arch.num_layers, "fused_xent": xent,
        "experts_sha256": experts_sha256}
    with open(out_path, "w") as fh:
        json.dump(report, fh)


def expert_digest(torch, params, ctx) -> str:
    """sha256 over this rank's expert leaves (``trainer.expert_mask``), in
    tree order, as their bytes on the host."""
    import hashlib

    import numpy as np
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    h = hashlib.sha256()
    for leaf, is_expert in zip(adamw.tree_leaves(params),
                               trainer.expert_mask(params, ctx)):
        if is_expert:
            raw = leaf.detach().contiguous().view(torch.uint8).cpu()
            h.update(np.asarray(raw).tobytes())
    return h.hexdigest()


def fused_xent_case(torch, ctx, run, res, batch) -> dict:
    """The fused cross entropy on the trained state: the loss and peak
    device memory of one forward and backward with the default loss and
    with ``fused_xent`` on the same parameters and batch (gradients
    dropped, nothing updated), then one training step with it whose
    launches are counted on their own (``launches``)."""
    import dataclasses

    from repro_torch.kernels import backend
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    fused = dataclasses.replace(ctx, fused_xent=True)
    out = {}
    for name, c in (("default", ctx), ("fused", fused)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        total, _ = transformer.loss_fn(res.params, batch, c,
                                       aux_weight=run.aux_weight)
        total.backward()
        torch.cuda.synchronize()
        out[name] = {"loss": float(total.detach()),
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "above_resident_gb":
                         (torch.cuda.max_memory_allocated() - base) / 1e9}
        del total
        for p in adamw.tree_leaves(res.params):
            p.grad = None
    step = trainer.make_train_step(fused, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    t0 = time.perf_counter()
    _, _, m = step(res.params, res.opt_state, batch)
    torch.cuda.synchronize()
    out["step"] = {"loss": float(m["loss"]),
                   "step_s": time.perf_counter() - t0,
                   "max_memory_allocated_gb":
                       torch.cuda.max_memory_allocated() / 1e9}
    out["launches"] = dict(backend.LAUNCHES)
    d, f = out["default"]["loss"], out["fused"]["loss"]
    out["rel_diff"] = abs(f - d) / abs(d)
    return out


def remat_memory(torch, arch, run, res, batch) -> dict:
    """With remat and without, on the trained state: the device memory one
    microbatch's forward holds for its backward (``forward_held_gb``:
    allocated after the loss minus before it, the activations remat
    drops), then the peak device memory (``max_memory_allocated`` after
    ``reset_peak_memory_stats``) and wall time of one more training step
    on the same batch."""
    import dataclasses

    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.training import trainer
    out = {}
    rows = batch["tokens"].shape[0] // trainer.num_microbatches(run)
    for remat in (True, False):
        ctx = model_lib.build_ctx(arch, None, seq_len=run.seq_len,
                                  global_batch=run.global_batch,
                                  aux_mode=run.aux_mode, remat=remat,
                                  device="cuda")
        step = trainer.make_train_step(
            ctx, dataclasses.replace(run, remat=remat))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        total, _ = transformer.loss_fn(
            res.params, {k: v[:rows] for k, v in batch.items()}, ctx,
            aux_weight=run.aux_weight)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        del total, _
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(res.params, res.opt_state, batch)
        torch.cuda.synchronize()
        out["remat" if remat else "no_remat"] = {
            "forward_held_gb": held / 1e9,
            "step_s": time.perf_counter() - t0,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "above_resident_gb": (torch.cuda.max_memory_allocated() - base)
            / 1e9}
    out["saved_peak_gb"] = (out["no_remat"]["max_memory_allocated_gb"]
                            - out["remat"]["max_memory_allocated_gb"])
    out["saved_held_gb"] = (out["no_remat"]["forward_held_gb"]
                            - out["remat"]["forward_held_gb"])
    return out


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
    and device time, busy share, launches, the top kernels, the device
    time of the kernels launched inside each profiler range of
    PROFILED_RANGES (K1's and K2's scatters apart from the ragged FFN's
    weight scatters; K7's forward apart from its weight quantization), and
    each hand-written kernel's launches and device time by name
    (``port_kernels``).  The profiler credits a range with the PyTorch
    operators' kernels only: a kernel launched through ctypes is in
    ``port_kernels``, not in its range."""
    import re

    import chip_ab
    from repro_torch.kernels import backend
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
              and e.key not in PROFILED_RANGES]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    for name in (n for src in backend.sources()
                 for n in chip_ab.kernel_names(REPO, src)):
        hits = [e for e in events if re.search(rf"\b{name}\b", e.key)]
        if hits:
            port[name] = {"count": sum(e.count for e in hits),
                          "device_ms": sum(e.self_device_time_total
                                           for e in hits) / 1e3}
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:60], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top],
            "port_kernels": port,
            "ranges": {
                e.key: {"count": e.count,
                        "device_ms": e.device_time_total / 1e3}
                for e in averages
                if e.key in PROFILED_RANGES and e.device_type.name == "CPU"}}


def spare_row_backwards(torch):
    """K1's and K2's backwards as the port first had them, every sentinel
    slot (dropped pick) added into one spare row, under the ranges of the
    shipped ones: the yardstick the train_2x2 phase profiles one more
    step with.  Returns ``{Function: backward}``."""
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import _with_zero_row

    def permute_bwd(ctx, g):
        (slot_to_token,) = ctx.saved_tensors
        with torch.profiler.record_function(PROFILED_RANGES[0]):
            gx = g.new_zeros((ctx.num_tokens + 1, g.shape[-1]))
            gx.index_add_(0, slot_to_token.long(), g)
            return gx[:ctx.num_tokens], None, None

    def unpermute_bwd(ctx, g):
        y, inv_idx, inv_w = ctx.saved_tensors
        S, d = y.shape
        with torch.profiler.record_function(PROFILED_RANGES[1]):
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


def resilient_phase(out_path: str) -> None:
    """The resilient runtime at full width on one rank, in two parts.

    1. One layer (0.32 B parameters; a checkpoint of params and AdamW
       moments is about 3.2 GB) under ``RESILIENT_CHAOS``: rolling
       checkpoints every 2 steps (2 kept) in a temporary directory that
       is deleted after; a NaN-gradient step must be skipped, and the
       spike must be rolled back at the last step to the newest
       checkpoint that verifies: the newest (step 5) is corrupted, so the
       step-3 one, whose tensors the returned state must equal bit for
       bit.  Then ``ckpt.save``, ``verify`` and ``restore_into``
       (``check_hashes=False``, as the rollback calls it after ``verify``)
       are timed once each on the final state (bytes and seconds).
    2. Full depth: the unguarded and the guarded loop (no chaos) on the
       same initial weights, in turns (unguarded, guarded, guarded,
       unguarded), ``GUARD_STEPS`` steps each: their losses must agree
       within LOSS_RTOL, and the steady step walls give the guard's
       cost.

    Launch counters are set to 0 before each run and read after it."""
    import dataclasses

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.kernels import backend
    from repro_torch.optim import adamw
    from repro_torch.resilience import ChaosConfig, ResilienceConfig
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config(ARCH_ID)
    arch = dataclasses.replace(full, num_layers=1)
    base = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_1,
                warmup_steps=1, aux_mode="ta", seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    report = {}
    try:
        res = ResilienceConfig(rollback_on_spike=True, spike_factor=1.5,
                               spike_patience=2, spike_warmup=3,
                               chaos=ChaosConfig(**RESILIENT_CHAOS))
        ck = os.path.join(tmp, "ck.npz")
        backend.reset_launches()
        t0 = time.perf_counter()
        r = trainer.train(arch, RunConfig(resilience=res, **base), None,
                          steps=RESILIENT_STEPS, log_every=1, verbose=True,
                          ckpt_path=ck, ckpt_every=2, ckpt_keep=2,
                          device="cuda")
        run_s = time.perf_counter() - t0
        launches = dict(backend.LAUNCHES)
        if (r.skipped_steps, r.rollbacks) != (1, 1):
            raise SystemExit(f"train_resilient: {r.skipped_steps} skipped "
                             f"steps and {r.rollbacks} rollbacks, the chaos "
                             f"schedule needs 1 and 1")
        newest = os.path.join(tmp, "ck-000005.npz")
        if ckpt.verify(newest):
            raise SystemExit("train_resilient: the corrupted step-5 "
                             "checkpoint verifies")
        state = {"params": r.params, "opt": r.opt_state}
        good = ckpt.restore(os.path.join(tmp, "ck-000003.npz"), state)
        live = adamw.tree_leaves([state["params"], state["opt"]["mu"],
                                  state["opt"]["nu"]])
        saved = adamw.tree_leaves([good["params"], good["opt"]["mu"],
                                   good["opt"]["nu"]])
        unequal = sum(not torch.equal(a.detach(), b)
                      for a, b in zip(live, saved))
        if unequal or good["opt"]["step"] != r.opt_state["step"]:
            raise SystemExit(f"train_resilient: {unequal} restored tensors "
                             f"differ from the step-3 checkpoint")
        del good, saved
        torch.cuda.synchronize()
        timed = os.path.join(tmp, "timed.npz")
        t0 = time.perf_counter()
        ckpt.save(timed, state, step=RESILIENT_STEPS)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = ckpt.verify(timed)
        verify_s = time.perf_counter() - t0
        # as the rollback restores: verify hashed every leaf already
        t0 = time.perf_counter()
        ckpt.restore_into(timed, state, check_hashes=False)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        nbytes = os.path.getsize(timed)
        if not ok:
            raise SystemExit("train_resilient: a fresh checkpoint does not "
                             "verify")
        hist = r.metrics_history
        report["chaos"] = {
            "layers": 1, "params": sum(t.numel() for t in
                                       adamw.tree_leaves(r.params)),
            "steps": RESILIENT_STEPS, "chaos": RESILIENT_CHAOS,
            "losses": r.losses, "nonfinite": [h["nonfinite"] for h in hist],
            "skipped_steps": r.skipped_steps, "rollbacks": r.rollbacks,
            "rolled_back_to_step": 3, "restored_bit_equal": True,
            "launches": launches, "run_s": run_s,
            "step_wall_s": r.step_seconds,
            "checkpoint_bytes": nbytes, "save_s": save_s,
            "verify_s": verify_s, "restore_s": restore_s,
            "restore_check_hashes": False,
            "rollback_s": verify_s + restore_s,
            "save_gb_per_s": nbytes / 1e9 / save_s,
            "verify_gb_per_s": nbytes / 1e9 / verify_s,
            "restore_gb_per_s": nbytes / 1e9 / restore_s}
        del r, state, live
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    runs, guard_launches = [], {}
    for label in ("unguarded", "guarded", "guarded", "unguarded"):
        run = RunConfig(resilience=ResilienceConfig() if label == "guarded"
                        else None, **base)
        backend.reset_launches()
        r = trainer.train(full, run, None, steps=GUARD_STEPS, log_every=1,
                          verbose=False, device="cuda")
        for k, v in backend.LAUNCHES.items():
            guard_launches[k] = guard_launches.get(k, 0) + v
        runs.append({"label": label, "losses": r.losses,
                     "step_wall_s": r.step_seconds})
        del r
        gc.collect()
        torch.cuda.empty_cache()
    ref = runs[0]["losses"]
    worst = max(abs(a - b) / abs(b) for g in runs for a, b in
                zip(g["losses"], ref))
    if not worst <= LOSS_RTOL or not all(math.isfinite(v) for g in runs
                                         for v in g["losses"]):
        raise SystemExit(f"train_resilient: guarded and unguarded losses "
                         f"differ by {worst} (relative) > {LOSS_RTOL}")

    def steady(label):
        walls = [w for g in runs if g["label"] == label
                 for w in g["step_wall_s"][1:]]
        return sum(walls) / len(walls)

    report["guard"] = {
        "layers": full.num_layers, "steps": GUARD_STEPS, "runs": runs,
        "max_rel_loss_diff": worst, "rtol": LOSS_RTOL,
        "steady_step_s_unguarded": steady("unguarded"),
        "steady_step_s_guarded": steady("guarded"),
        "guard_cost": steady("guarded") / steady("unguarded") - 1.0,
        "launches": guard_launches}
    report["launches"] = {k: report["chaos"]["launches"][k]
                          + guard_launches[k] for k in guard_launches}
    with open(out_path, "w") as fh:
        json.dump(report, fh)


def replan_rank(world, out_dir: str) -> None:
    """One rank of the 2x2 world under the degraded-link chaos
    (``REPLAN_RESILIENCE``): ``trainer.train`` at full width and depth
    ``REPLAN_LAYERS``, the measured links (``comm_model.measure_link``
    over gloo, cached per process, so the later probe reads the first
    one's fit), the caps before and after the replan, and the caps the
    port's planner gives with the pod level's beta scaled to inf.  The
    step function the replan builds keeps a copy of the parameters and
    batch of its first call; after the run the plain path (kernels off by
    ``use_pallas=False`` and ``REPRO_TORCH_KERNELS=0``) computes that
    step's world-mean loss from them under the replanned context, to hold
    against the loss the run logged.  Writes ``replan<rank>.json``."""
    import contextlib
    import dataclasses
    import io
    import re

    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.core import capacity, comm_model, topology
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.resilience import ChaosConfig, ResilienceConfig
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(get_config(ARCH_ID), num_layers=REPLAN_LAYERS)
    res = ResilienceConfig(chaos=ChaosConfig(**REPLAN_CHAOS),
                           **REPLAN_RESILIENCE)
    run = RunConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH_22,
                    warmup_steps=1, aux_mode="ta", seed=0, resilience=res)
    ctx = model_lib.build_ctx(arch, world, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH_22, aux_mode="ta",
                              device="cuda")
    plan = ctx.plan
    want = capacity.make_dispatch_plan(
        tokens_per_device=plan.tokens_per_device,
        num_experts=plan.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor,
        axis_sizes=plan.axis_sizes, axis_names=ctx.ep.axis_names,
        mode=plan.mode, comm=topology.tree_topology_nd(plan.axis_sizes),
        level_beta_scale=(1.0,) * len(plan.axis_sizes) + (math.inf,))
    first = {}
    guarded_step = trainer.make_guarded_train_step

    def keeping_first_after_replan(c, run_cfg):
        step = guarded_step(c, run_cfg)
        if c.plan.caps == plan.caps:
            return step

        def kept(params, opt_state, batch, *rest):
            if not first:
                first.update(ctx=c, params=_clone_tree(params),
                             batch=_clone_tree(batch))
            return step(params, opt_state, batch, *rest)
        return kept

    log = io.StringIO()
    trainer.make_guarded_train_step = keeping_first_after_replan
    backend.reset_launches()
    try:
        with contextlib.redirect_stdout(log):
            r = trainer.train(arch, run, world, steps=REPLAN_STEPS,
                              log_every=1, verbose=True, device="cuda")
    finally:
        trainer.make_guarded_train_step = guarded_step
    launches = dict(backend.LAUNCHES)
    plain_loss = None
    if first:
        os.environ[backend.ENV_VAR] = "0"
        with torch.no_grad():
            _, m = transformer.loss_fn(
                first["params"], first["batch"],
                dataclasses.replace(first["ctx"], use_pallas=False),
                aux_weight=run.aux_weight)
            plain_loss = float(trainer.world_mean_metrics(
                {"loss": m["loss"]}, world)["loss"])
        del os.environ[backend.ENV_VAR]
        first.clear()
    links = comm_model.measured_ep_links(world, ctx.ep.axis_names)
    after = re.findall(r"replan: caps -> \(([0-9, ]*)\)", log.getvalue())
    report = {
        "rank": world.rank, "coords": list(world.coords),
        "layers": REPLAN_LAYERS, "losses": r.losses,
        "replans": r.replans, "caps_before": list(plan.caps),
        "first_replanned_step": res.replan_every,
        "plain_first_replanned_loss": plain_loss,
        "caps_after": [[int(c) for c in a.split(",") if c.strip()]
                       for a in after],
        "planner_caps_pod_beta_inf": list(want.caps),
        "launches": launches, "step_wall_s": r.step_seconds,
        "links": {ax: None if li is None else
                  {"alpha_s": li.alpha, "beta_s_per_byte": li.beta,
                   "gb_per_s": 1e-9 / li.beta, "nbytes": list(li.nbytes),
                   "times_s": list(li.times)}
                  for ax, li in links.items()},
        "log": log.getvalue()}
    with open(os.path.join(out_dir, f"replan{world.rank}.json"), "w") as fh:
        json.dump(report, fh)


def train_rank(world, out_dir: str, global_batch: int, dispatch: str = "a2a",
               wire_codec: str = "", steps: int = TRAIN_STEPS,
               layers: int = 0, spare_row: bool = False,
               hash_experts: bool = False) -> None:
    train_phase(world, os.path.join(out_dir, f"rank{world.rank}.json"),
                global_batch, dispatch, wire_codec, steps, layers=layers,
                spare_row=spare_row, hash_experts=hash_experts)


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


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.detach().clone()


def _cast_params(params, dtype):
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def e2e_logits(torch, params, ctx, prompt, world=None):
    """Prefill of ``prompt`` [B, S] then E2E_STEPS decode steps, each fed
    the prompt's last token: float32 logits [E2E_STEPS + 1, B, V].  On a
    world every rank passes the whole batch, runs its rows, and gets the
    whole batch's logits (gathered)."""
    from repro_torch.launch.mesh import gather_rows
    from repro_torch.serving import engine
    rank, n = (0, 1) if world is None else (world.rank, world.size)
    B = prompt.shape[0]
    mine = prompt[rank * B // n:(rank + 1) * B // n]
    prefill = engine.make_prefill(ctx, with_cache=True, cache_len=64)
    step = engine.make_decode_step(ctx)
    lg, cache = prefill(params, {"tokens": mine})
    traj = [gather_rows(world, lg)]
    tok = mine[:, -1:]
    for _ in range(E2E_STEPS):
        out, cache = step(params, cache, tok)
        traj.append(gather_rows(world, out[:, 0]))
    return torch.stack(traj)


def e2e_verdict(torch, got, f32, bf16, label: str) -> dict:
    """The kernel path's logits ``got`` against the float32 plain run's:
    at most E2E_RATIO times as far (relative Frobenius) as the bf16 plain
    run's ``bf16``, or E2E_FLOOR; raises otherwise."""
    def rel(a):
        return float(torch.linalg.vector_norm(a - f32)
                     / torch.linalg.vector_norm(f32))

    rel_kernel, rel_plain = rel(got), rel(bf16)
    agree = float((got.argmax(-1) == f32.argmax(-1)).float().mean())
    limit = max(E2E_RATIO * rel_plain, E2E_FLOOR)
    if not (math.isfinite(rel_kernel) and rel_kernel <= limit):
        raise SystemExit(f"{label}: kernel path logits are {rel_kernel} "
                         f"(relative) from the float32 reference, the plain "
                         f"bf16 path {rel_plain}; limit {limit}")
    return {"rel_err_kernel_vs_f32": rel_kernel,
            "rel_err_plain_bf16_vs_f32": rel_plain, "limit": limit,
            "argmax_agreement_kernel_vs_f32": agree}


class CastLayers(list):
    """A model's layers, each cast to ``dtype`` when the forward reads it
    (``params["layers"][i]``): a float32 run of a model whose float32
    copy would not fit the card beside its bf16 weights holds one layer's
    at a time."""

    def __init__(self, layers, dtype):
        super().__init__(layers)
        self.dtype = dtype

    def __getitem__(self, i):
        return _cast_params(list.__getitem__(self, i), self.dtype)


def plain_runs(torch, params, ctx, prompt, kernel=True,
               f32_by_layer=False) -> dict:
    """``e2e_logits`` on one rank through the kernel path (with
    ``kernel``), the bf16 plain path and a float32 plain run of the same
    weights (with ``f32_by_layer``, each layer cast as it is read:
    ``CastLayers``)."""
    import dataclasses
    plain_ctx = dataclasses.replace(ctx, use_pallas=False, use_flash=False)
    f32_ctx = dataclasses.replace(
        plain_ctx, arch=dataclasses.replace(ctx.arch, dtype="float32"))

    def f32_params():
        if not f32_by_layer:
            return _cast_params(params, torch.float32)
        out = {k: _cast_params(v, torch.float32)
               for k, v in params.items() if k != "layers"}
        out["layers"] = CastLayers(params["layers"], torch.float32)
        return out

    runs = (("plain_bf16", plain_ctx, lambda: params),
            ("plain_f32", f32_ctx, f32_params))
    if kernel:
        runs = (("kernel", ctx, lambda: params),) + runs
    return {name: e2e_logits(torch, make(), c, prompt)
            for name, c, make in runs}


def end_to_end_check(torch, np, params, ctx):
    """The kernel path against a float32 plain reference on the card: one
    32-token prompt, prefill + 4 decode steps.  The bf16 plain path (no
    kernels) is measured against the same reference; the kernel path must
    be no further from it than E2E_RATIO times that, or E2E_FLOOR."""
    rng = np.random.default_rng(7)
    prompt = torch.as_tensor(rng.integers(0, ctx.arch.vocab_size,
                                          size=(1, E2E_PROMPT)),
                             dtype=torch.int32, device="cuda")
    logits = plain_runs(torch, params, ctx, prompt)
    return e2e_verdict(torch, logits["kernel"], logits["plain_f32"],
                       logits["plain_bf16"], "end to end")


def profile_steps(torch, params, ctx, world=None):
    """Step times (host clock around synchronized runs) and a
    torch.profiler breakdown of one prefill pack and one decode step at
    the serve phase's shapes: device busy share and the top kernels by
    device time.  On a world each rank runs its rows of the pack and its
    slots, in step with the others."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode
    from repro_torch.serving import engine
    rank, n = (0, 1) if world is None else (world.rank, world.size)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, ctx.arch.vocab_size, (PACK, BUCKET),
                           generator=gen, device="cuda", dtype=torch.int32)
    tokens = tokens[rank * PACK // n:(rank + 1) * PACK // n]
    prefill = engine.make_prefill(ctx, with_cache=True, cache_len=CACHE_LEN)
    step = engine.make_decode_step(ctx)
    cache = decode.init_cache(ctx, NUM_SLOTS // n, CACHE_LEN)
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
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
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


def checks_dsv2_lite(torch, params, ctx, gen) -> dict:
    """K4, K1, K2, K3 and K7 at DeepSeek-V2-Lite's full width (swiglu, d
    2048, f 1408, top-6 of 64) on layer DSV2_MOE_LAYER's weights, each
    against its plain version: K4 at the serve's decode (8 slots) and
    prefill (4 x 128) gather layouts and at train_dsv2_lite_d4's one-rank
    layout (its first batch's 2048 tokens through the embedding and layer
    0, routed on the a2a plan: capacity segments with sentinel slots and
    dropped picks), with its compaction bit-equal at each; K1
    (bit-equal), K2 (six picks a token) and K3 at ``staged_case``'s 2x2
    rank-0 layout; K7 at ``pipelined_case``'s chunk 0 (the overlap model's
    chunk count at these widths)."""
    arch = ctx.arch
    layer = DSV2_MOE_LAYER
    k4, compaction = {}, []
    for label, Tg in (("decode", NUM_SLOTS), ("prefill", PACK * BUCKET)):
        args, act = gather_k4_case(torch, params, ctx, Tg, gen, layer=layer)
        if act != "swiglu":
            raise SystemExit(f"dsv2_lite {label}: activation {act}")
        k4[label] = check_k4(torch, args, act, f"dsv2_lite_{label}")
        compaction.append(check_compaction(torch, args,
                                           f"dsv2_lite_{label}"))
        del args
    case = staged_case(torch, params, arch, gen, layer=layer)
    di = case["di"]
    k1 = check_k1(torch, case["x"], di.slot_to_token)
    k2 = check_k2(torch, torch.randn(
        (di.num_slots, arch.d_model), generator=gen,
        device="cuda").to(torch.bfloat16), di)
    k3 = check_k3(torch, case)
    layout = {"caps": list(case["caps"]), "S": di.num_slots,
              "T": case["x"].shape[0], "picks": di.inv_idx.shape[1]}
    del case
    pcase = pipelined_case(torch, params, arch, gen, layer=layer,
                           chunks=None)
    k7 = check_k7(torch, pcase)
    del pcase
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    tokens = SyntheticLM(DataConfig(
        vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH_1, seed=0)).batch(0)["tokens"].cuda()
    args, act = train1_k4_case(torch, params, arch, gen, layer=layer,
                               x=moe_rows(torch, params, ctx, tokens, layer))
    k4["train_1rank"] = check_k4(torch, args, act, "dsv2_lite_train_1rank")
    compaction.append(check_compaction(torch, args,
                                       "dsv2_lite_train_1rank"))
    T = args[0].shape[0]
    layout_1rank = {"T": T, "slots": args[1].numel(),
                    "segments": len(args[4]),
                    "sentinel_slots": int((args[1] >= T).sum()),
                    "valid_rows": int(args[5].sum()),
                    "dropped_picks": T * arch.moe.top_k
                    - int(args[5].sum())}
    del args
    return {"K4": k4, "K4_compaction": compaction, "K1": k1, "K2": k2,
            "K3": k3, "K7": k7, "layout_2x2": layout,
            "layout_train_1rank": layout_1rank}


def serve_dsv2_lite(torch, np, params, ctx) -> dict:
    """Full-depth DeepSeek-V2-Lite on one rank through
    ``ServingEngine.run``: first the kernel path's logits (a 32-token
    prompt, prefill + 4 decode steps) against the bf16 plain path's, with
    the limit of ``e2e_verdict`` from a float32 plain run that casts one
    layer at a time (``CastLayers``); then a warm-up request and the serve
    phase's 8 requests, the counters set to 0 just before and read just
    after: K4 exactly once a MoE layer (26) of every prefill pack and
    decode step, every other kernel (K5 too: MLA attends in plain
    PyTorch) never; peak memory; a profiled prefill pack and decode
    step."""
    from repro_torch.kernels import backend
    from repro_torch.serving import engine
    arch = ctx.arch
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, arch.vocab_size, size=(1, E2E_PROMPT)), dtype=torch.int32,
        device="cuda")
    with torch.no_grad():
        logits = plain_runs(torch, params, ctx, prompt, f32_by_layer=True)
    e2e = e2e_verdict(torch, logits["kernel"], logits["plain_f32"],
                      logits["plain_bf16"], "serve_dsv2_lite end to end")
    e2e["rel_err_kernel_vs_plain_bf16"] = float(
        torch.linalg.vector_norm(logits["kernel"] - logits["plain_bf16"])
        / torch.linalg.vector_norm(logits["plain_bf16"]))
    del logits
    eng = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=NUM_SLOTS, cache_len=CACHE_LEN, prefill_pack=PACK,
        prompt_buckets=(BUCKET,)))
    rng = np.random.default_rng(0)
    eng.run(serve_requests(rng, arch.vocab_size, 1))          # warm-up
    reqs = serve_requests(rng, arch.vocab_size, NUM_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    report = eng.run(reqs)
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for st in report.streams:
        if st.evicted or len(st.generated) != st.request.max_new_tokens or \
                not all(0 <= t < arch.vocab_size for t in st.generated):
            raise SystemExit(f"serve_dsv2_lite request {st.request.uid}: "
                             f"{len(st.generated)} of "
                             f"{st.request.max_new_tokens} tokens, or a "
                             f"token outside the vocabulary")
    if len(report.streams) != NUM_REQUESTS:
        raise SystemExit(f"serve_dsv2_lite: {len(report.streams)} of "
                         f"{NUM_REQUESTS} streams finished")
    n_moe = arch.num_layers - arch.moe.first_dense
    want = {k: 0 for k in backend.LAUNCHES}
    want["moe_fused.local_moe"] = n_moe * (report.prefill_calls
                                           + report.decode_steps)
    if launches != want:
        raise SystemExit(f"serve_dsv2_lite: launches {launches}, the path "
                         f"needs {want}")
    with torch.no_grad():
        prof = profile_steps(torch, params, ctx)
    return {"layers": arch.num_layers, "moe_layers": n_moe,
            "end_to_end": e2e, "requests": len(report.streams),
            "new_tokens": report.total_new_tokens,
            "prompt_tokens": sum(len(r.tokens) for r in reqs),
            "decode_steps": report.decode_steps,
            "prefill_packs": report.prefill_calls,
            "wall_s": report.wall_time,
            "tokens_per_s": report.tokens_per_sec, "launches": launches,
            "max_memory_allocated_gb": peak, "profile": prof}


def e2e_dsv2_lite_d4(torch, np, params, ctx) -> dict:
    """The float32 three-way verdict (``e2e_verdict``: the kernel path,
    the bf16 plain path and a float32 plain run of a whole float32 copy)
    on DeepSeek-V2-Lite cut to DSV2_CUT_LAYERS layers at full width: the
    first layers of the serve phase's weights, the same prompt."""
    import dataclasses
    from repro_torch.models import model as model_lib
    arch = dataclasses.replace(ctx.arch, num_layers=DSV2_CUT_LAYERS)
    ctx4 = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                               aux_mode="none", seq_len=CACHE_LEN,
                               global_batch=NUM_SLOTS)
    params4 = dict(params, layers=params["layers"][:DSV2_CUT_LAYERS])
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, arch.vocab_size, size=(1, E2E_PROMPT)), dtype=torch.int32,
        device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = plain_runs(torch, params4, ctx4, prompt)
    out = e2e_verdict(torch, logits["kernel"], logits["plain_f32"],
                      logits["plain_bf16"], "e2e_dsv2_lite_d4")
    return {"layers": DSV2_CUT_LAYERS, **out,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9}


def serve_rank(world, out_dir: str) -> None:
    """One rank of serve_2x2: full-width gpt3_medium_moe from seed 0 (this
    rank's 16 experts a layer), ``ServeConfig`` as the serve phase's, the
    batch sharded over the world and every MoE layer through the gather
    path.  First the end-to-end check: the kernel path's logits for
    E2E_ROWS prompts (one a rank, gathered) against the one-rank float32
    and bf16 plain runs the main process saved (``e2e_reference.pt``);
    then a warm-up request, then the serve phase's 8 requests with the
    launch counters set to 0 just before and read just after, then the
    prefill pack's and decode step's times on this rank.  Writes
    ``serve<rank>.json``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_config(ARCH_ID)
    ctx = model_lib.build_ctx(arch, world, device="cuda", use_flash=True,
                              aux_mode="none", seq_len=CACHE_LEN,
                              global_batch=NUM_SLOTS)
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    ref = torch.load(os.path.join(out_dir, "e2e_reference.pt"))
    with torch.no_grad():
        got = e2e_logits(torch, params, ctx, ref["prompt"].cuda(), world)
    e2e = e2e_verdict(torch, got, ref["plain_f32"].cuda(),
                      ref["plain_bf16"].cuda(), "serve_2x2 end to end")
    del got, ref
    eng = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=NUM_SLOTS, cache_len=CACHE_LEN, prefill_pack=PACK,
        prompt_buckets=(BUCKET,)))
    rng = np.random.default_rng(0)
    eng.run(serve_requests(rng, arch.vocab_size, 1))          # warm-up
    reqs = serve_requests(rng, arch.vocab_size, NUM_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    report = eng.run(reqs)
    launches = dict(backend.LAUNCHES)
    with torch.no_grad():
        prof = profile_steps(torch, params, ctx, world)
    out = {"rank": world.rank, "coords": list(world.coords),
           "expert_range": list(ctx.expert_range), "end_to_end": e2e,
           "streams": {s.request.uid: s.generated for s in report.streams},
           "budgets": {s.request.uid: s.request.max_new_tokens
                       for s in report.streams},
           "evicted": sum(s.evicted for s in report.streams),
           "new_tokens": report.total_new_tokens,
           "prompt_tokens": sum(len(r.tokens) for r in reqs),
           "decode_steps": report.decode_steps,
           "prefill_packs": report.prefill_calls,
           "wall_s": report.wall_time,
           "tokens_per_s": report.tokens_per_sec, "launches": launches,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "profile": prof}
    with open(os.path.join(out_dir, f"serve{world.rank}.json"), "w") as fh:
        json.dump(out, fh)


def deepseek_phases(torch, np) -> tuple:
    """The DeepSeek-V2-Lite phases (DSV2_ID, one rank): its full-width
    weights from seed 0, ``checks_dsv2_lite``, ``serve_dsv2_lite`` and
    ``e2e_dsv2_lite_d4`` in this process; the weights freed, then
    ``train_dsv2_lite_d4`` in a child process.  Emits each phase's line
    and returns ``(checks, serve, train report)``."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import backend
    from repro_torch.models import model as model_lib
    t0 = time.time()
    arch_ds = get_config(DSV2_ID)
    ctx_ds = model_lib.build_ctx(arch_ds, device="cuda", use_flash=True,
                                 aux_mode="none", seq_len=CACHE_LEN,
                                 global_batch=NUM_SLOTS)
    params_ds = model_lib.init_params(
        ctx_ds, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": "init_dsv2_lite", "arch": arch_ds.name,
          "source": arch_ds.source, "layers": arch_ds.num_layers,
          "params": model_lib.count_params(params_ds),
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "seconds": time.time() - t0})
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        ck_ds = checks_dsv2_lite(torch, params_ds, ctx_ds, gen)
    emit({"phase": "checks_dsv2_lite", "seconds": time.time() - t0,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9, **ck_ds})
    t0 = time.time()
    srv_ds = serve_dsv2_lite(torch, np, params_ds, ctx_ds)
    emit({"phase": "serve_dsv2_lite", "seconds": time.time() - t0,
          **srv_ds})
    t0 = time.time()
    e2e_ds = e2e_dsv2_lite_d4(torch, np, params_ds, ctx_ds)
    emit({"phase": "e2e_dsv2_lite_d4", "seconds": time.time() - t0,
          **e2e_ds})
    del params_ds
    gc.collect()
    torch.cuda.empty_cache()
    # one rank, depth cut to DSV2_CUT_LAYERS, in a child process
    t0 = time.time()
    tmp_ds = tempfile.mkdtemp(prefix="chip_smoke_dsv2_")
    child = mp.get_context("spawn").Process(
        target=train_phase, args=(None, os.path.join(tmp_ds, "train.json"),
                                  TRAIN_BATCH_1),
        kwargs={"layers": DSV2_CUT_LAYERS, "arch_id": DSV2_ID})
    child.start()
    child.join()
    if child.exitcode != 0:
        raise SystemExit(f"train_dsv2_lite_d4: the child process failed "
                         f"(exit {child.exitcode})")
    with open(os.path.join(tmp_ds, "train.json")) as fh:
        tds = json.load(fh)
    shutil.rmtree(tmp_ds, ignore_errors=True)
    n_moe_ds = DSV2_CUT_LAYERS - arch_ds.moe.first_dense
    check_ds = check_training(
        [tds], {k: (n_moe_ds * TRAIN_STEPS if k == "moe_fused.local_moe"
                    else 0) for k in backend.LAUNCHES},
        "train_dsv2_lite_d4")
    emit({"phase": "train_dsv2_lite_d4", "seconds": time.time() - t0,
          "arch": arch_ds.name, "depth_cut": f"{arch_ds.num_layers} -> "
          f"{DSV2_CUT_LAYERS}: AdamW's float32 moments of 15.5 B "
          f"parameters alone are 124 GB", "aux_mode": "ta",
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check_ds, **tds})
    return ck_ds, srv_ds, tds


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
    from repro_torch.launch import mesh
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
        k4_cases = {
            "decode": gather_k4_case(torch, params, ctx, NUM_SLOTS, gen),
            "prefill": gather_k4_case(torch, params, ctx, PACK * BUCKET, gen)}
        k4 = {label: check_k4(torch, *c, label)
              for label, c in k4_cases.items()}
        k4_edge_cases = {
            "decode_swiglu": gather_k4_case(torch, params, ctx, NUM_SLOTS,
                                            gen, swiglu=True),
            "ragged_swiglu": gather_k4_case(torch, params, ctx, 100, gen,
                                            swiglu=True),
            "edges_gelu": k4_edge_case(torch, params, ctx, gen),
            "edges_swiglu": k4_edge_case(torch, params, ctx, gen,
                                         swiglu=True)}
        k4_edges = [check_k4(torch, *c, label, timed=False)
                    for label, c in k4_edge_cases.items()]
        compaction = [check_compaction(torch, c[0], label)
                      for label, c in {**k4_cases, **k4_edge_cases}.items()]
        del k4_cases, k4_edge_cases
        # K4 on serve_2x2's gather layouts: rank (0, 0)'s 16 experts over
        # the world's gathered decode tokens (8 slots) and one gathered
        # prefill pack
        for label, Tg in (("decode_2x2", NUM_SLOTS),
                          ("prefill_2x2", PACK * BUCKET)):
            c = gather_k4_case(torch, params, ctx, Tg, gen, rank=0,
                               ep_world=math.prod(WORLD_22))
            k4[label] = check_k4(torch, *c, label)
            compaction.append(check_compaction(torch, c[0], label))
            del c
        hd = arch.head_dim_
        k5 = check_k5(torch, (PACK, BUCKET, arch.num_heads, hd), gen)
        # the training sequence length, for information (training attends
        # through the plain _sdpa)
        k5_512 = check_k5(torch, (PACK, TRAIN_SEQ, arch.num_heads, hd), gen)
        edges = [check_k5(torch, (2, 100, arch.num_heads, hd), gen,
                          timed=False),
                 check_k5(torch, (1, 77, 4, hd), gen, window=16,
                          timed=False),
                 check_k5(torch, (1, 50, 4, hd), gen, causal=False,
                          timed=False),
                 check_k5(torch, (2, 96, arch.num_heads, hd), gen,
                          kv_heads=4, timed=False),
                 check_k5(torch, (2, 200, arch.num_heads, hd), gen,
                          window=70, kv_heads=8, timed=False)]
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
        k3e = k3_edges(torch, case, gen)
        # K1-K3 at train_2x2_replan's layout after its replan
        rcase = staged_case(torch, params, arch, gen, slowdowns={
            ax: m for _, ax, m in REPLAN_CHAOS["degraded_links"]})
        if rcase["caps"][-1] != 0:
            raise SystemExit(f"the replanned layout has caps "
                             f"{rcase['caps']}, not an empty last stage")
        k_replan = layout_checks(torch, rcase, gen)
        layout_replan = (rcase["x"].shape[0], rcase["di"])
        del rcase
        # K1-K3 at train_2x2x2's layout: rank (0, 0, 0), three stages
        case3 = staged_case(torch, params, arch, gen,
                            sizes=mesh.mesh_from_topology(SPEC_222),
                            global_batch=TRAIN_BATCH_222)
        if len(case3["caps"]) != 3 or min(case3["caps"]) <= 0:
            raise SystemExit(f"the 2x2x2 layout has caps {case3['caps']}, "
                             f"not three stages")
        di3 = case3["di"]
        label3 = f"2x2x2 S={di3.num_slots}"
        k1[label3] = check_k1(torch, case3["x"], di3.slot_to_token)
        k2[label3] = check_k2(torch, torch.randn(
            (di3.num_slots, arch.d_model), generator=gen,
            device="cuda").to(torch.bfloat16), di3)
        k3_222 = check_k3(torch, case3)
        k_222 = layout_checks(torch, case3, gen)
        layout222 = (case3["x"].shape[0], di3)
        del case3
        # K7 on the whole staged buffer too: its expert spans of 304 rows
        # cross 64-row tiles, which chunk 0's spans of 38 do not
        k7_full = check_k7(torch, case)
        layout22 = (case["x"].shape[0], case["di"])
        del case
        k7 = check_k7(torch, pcase)
        del pcase
        train1 = train1_k4_case(torch, params, arch, gen)
        k4["train_1rank"] = check_k4(torch, *train1, "train_1rank")
        compaction.append(check_compaction(torch, train1[0], "train_1rank"))
        del train1
        x6, w_in6, w_out6, filled = einsum_k6_case(torch, params, arch, gen)
        k6 = check_k6(torch, x6, w_in6, None, w_out6, "einsum", filled)
        k6_edges = check_k6_edges(torch, x6, w_in6, w_out6, gen)
        del x6
        H, K = arch.num_heads, arch.num_kv_heads
        k8 = check_k8(torch, gen, DECODE_B, DECODE_L, H, K, timed=True)
        gc.collect()
        torch.cuda.empty_cache()
        k8_edges = [check_k8(torch, gen, 4, 4096, H, 4),
                    check_k8(torch, gen, 4, 8192, H, K, window=4096),
                    check_k8(torch, gen, 4, 1000, H, K,
                             lengths=[0, 1, 537, 1000])]
    emit({"phase": "checks", "K4": k4, "K4_edges": k4_edges,
          "K4_compaction": compaction, "K5": k5,
          "K5_S512": k5_512, "K5_edges": edges, "K1": k1,
          "K1_edges": k1_edges, "K2": k2, "K2_edges": k2_edges, "K3": k3,
          "K3_edges": k3e, "K1_K2_K3_replan_layout": k_replan,
          "K3_2x2x2": k3_222, "K1_K2_K3_2x2x2_layout": k_222,
          "K7": k7, "K7_S4864": k7_full,
          "K6": k6, "K6_edges": k6_edges, "K8": k8, "K8_edges": k8_edges})
    bwd = backward_checks(torch, gen, {"2x2": layout22,
                                       "replan": layout_replan,
                                       "2x2x2": layout222})
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
    # the one-rank plain runs (bf16 and float32) that serve_2x2's
    # end-to-end check holds the world's kernel path to
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    prompt = torch.as_tensor(np.random.default_rng(8).integers(
        0, arch.vocab_size, size=(E2E_ROWS, E2E_PROMPT)), dtype=torch.int32,
        device="cuda")
    with torch.no_grad():
        ref = plain_runs(torch, params, ctx, prompt, kernel=False)
    torch.save({"prompt": prompt.cpu(),
                **{k: v.cpu() for k, v in ref.items()}},
               os.path.join(tmp, "e2e_reference.pt"))
    del params, eng, report, ref
    gc.collect()
    torch.cuda.empty_cache()

    # 5. serving on the 2x2 EP world: four ranks share the card over gloo
    t0 = time.time()
    mesh.spawn(serve_rank, WORLD_22, "gloo", "cuda", args=(tmp,))
    srv = []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(tmp, f"serve{r}.json")) as fh:
            srv.append(json.load(fh))
    n_layers = arch.num_layers
    for r in srv:
        if r["evicted"] or len(r["streams"]) != NUM_REQUESTS or any(
                len(toks) != r["budgets"][uid]
                or not all(0 <= t < arch.vocab_size for t in toks)
                for uid, toks in r["streams"].items()):
            raise SystemExit(f"serve_2x2 rank {r['rank']}: streams "
                             f"incomplete or outside the vocabulary")
        if r["streams"] != srv[0]["streams"]:
            raise SystemExit(f"serve_2x2 rank {r['rank']}: its streams "
                             f"differ from rank 0's")
        want_s = {k: 0 for k in backend.LAUNCHES}
        want_s["moe_fused.local_moe"] = n_layers * (r["prefill_packs"]
                                                    + r["decode_steps"])
        want_s["flash_attn.flash_attention"] = n_layers * r["prefill_packs"]
        if r["launches"] != want_s:
            raise SystemExit(f"serve_2x2 rank {r['rank']}: launches "
                             f"{r['launches']}, the path needs {want_s}")
    emit({"phase": "serve_2x2", "seconds": time.time() - t0,
          "world": list(WORLD_22), "backend": "gloo",
          "layers": n_layers, "ranks": srv})

    # 6. training, one rank, in a child process (it frees the card when it
    # ends); the kernels were built above, so the child only loads them;
    # after the run, the fused cross entropy on its state
    t0 = time.time()
    child = mp.get_context("spawn").Process(
        target=train_phase, args=(None, os.path.join(tmp, "rank0.json"),
                                  TRAIN_BATCH_1), kwargs={"fused_xent": True})
    child.start()
    child.join()
    if child.exitcode != 0:
        raise SystemExit(f"train_1rank: the child process failed (exit "
                         f"{child.exitcode})")
    with open(os.path.join(tmp, "rank0.json")) as fh:
        one = json.load(fh)
    zero = {k: 0 for k in ("moe_permute.permute", "moe_permute.unpermute",
                           "moe_gemm.grouped_ffn_ragged")}
    off = {k: 0 for k in OFF_PATH}
    check1 = check_training(
        [one], dict(zero, **off,
                    **{"moe_fused.local_moe": n_layers * TRAIN_STEPS,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_1rank")
    xent = one["fused_xent"]
    want_x = {k: 0 for k in backend.LAUNCHES}
    want_x["moe_fused.local_moe"] = n_layers
    if not xent["rel_diff"] <= LOSS_RTOL or xent["launches"] != want_x:
        raise SystemExit(f"train_1rank fused_xent: loss {xent['fused']} "
                         f"against {xent['default']} (relative "
                         f"{xent['rel_diff']}, limit {LOSS_RTOL}); launches "
                         f"{xent['launches']}, the step needs {want_x}")
    emit({"phase": "train_1rank", "seconds": time.time() - t0,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check1, **one})

    # 7. training, 2x2 EP world: four ranks share the card over gloo
    t0 = time.time()
    mesh.spawn(train_rank, WORLD_22, "gloo", "cuda",
               args=(tmp, TRAIN_BATCH_22, "a2a", "", TRAIN_STEPS, 0, True))
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
    check_e = check_training(
        [ein], {k: (n_layers * TRAIN_STEPS if k == "moe_gemm.grouped_ffn"
                    else 0) for k in backend.LAUNCHES},
        "train_einsum_k6")
    emit({"phase": "train_einsum_k6", "seconds": time.time() - t0,
          "dispatch": "einsum", "aux_mode": "lb", "use_moe_kernel": True,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1,
          "steps": TRAIN_STEPS, **check_e, **ein})

    # 10. one rank, microbatch accumulation with remat, in a child process:
    # K4 runs once a layer and microbatch forward and again in the
    # recompute
    t0 = time.time()
    child = mp.get_context("spawn").Process(
        target=train_phase, args=(None, os.path.join(tmp, "accum.json"),
                                  ACCUM_BATCH),
        kwargs={"microbatch": ACCUM_MICRO, "remat": True})
    child.start()
    child.join()
    if child.exitcode != 0:
        raise SystemExit(f"train_1rank_accum_remat: the child process failed "
                         f"(exit {child.exitcode})")
    with open(os.path.join(tmp, "accum.json")) as fh:
        acc = json.load(fh)
    n_micro = ACCUM_BATCH // ACCUM_MICRO
    check_a = check_training(
        [acc], dict(zero, **off,
                    **{"moe_fused.local_moe": n_layers * n_micro * 2
                       * TRAIN_STEPS,
                       "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_1rank_accum_remat")
    emit({"phase": "train_1rank_accum_remat", "seconds": time.time() - t0,
          "seq_len": TRAIN_SEQ, "global_batch": ACCUM_BATCH,
          "microbatch": ACCUM_MICRO, "remat": True, "steps": TRAIN_STEPS,
          **check_a, **acc})

    # 11. the resilient runtime on one rank, in a child process
    t0 = time.time()
    child = mp.get_context("spawn").Process(
        target=resilient_phase, args=(os.path.join(tmp, "resilient.json"),))
    child.start()
    child.join()
    if child.exitcode != 0:
        raise SystemExit(f"train_resilient: the child process failed (exit "
                         f"{child.exitcode})")
    with open(os.path.join(tmp, "resilient.json")) as fh:
        resil = json.load(fh)
    want_r = {k: 0 for k in backend.LAUNCHES}
    want_r["moe_fused.local_moe"] = (RESILIENT_STEPS
                                     + n_layers * GUARD_STEPS * 4)
    if resil["launches"] != want_r:
        raise SystemExit(f"train_resilient: launches {resil['launches']}, "
                         f"the path needs {want_r}")
    emit({"phase": "train_resilient", "seconds": time.time() - t0,
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH_1, **resil})

    # 12. the 2x2 world through a degraded-link replan
    t0 = time.time()
    mesh.spawn(replan_rank, WORLD_22, "gloo", "cuda", args=(tmp,))
    rep = []
    for r in range(math.prod(WORLD_22)):
        with open(os.path.join(tmp, f"replan{r}.json")) as fh:
            rep.append(json.load(fh))
    per_step = {k: REPLAN_LAYERS * REPLAN_STEPS for k in zero}
    want_rp = dict({k: 0 for k in backend.LAUNCHES}, **per_step)
    for r in rep:
        if r["replans"] != 1 or len(r["caps_after"]) != 1:
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: "
                             f"{r['replans']} replans, the chaos needs 1")
        if (r["caps_after"][0] != r["planner_caps_pod_beta_inf"]
                or r["caps_after"][0][-1] != 0
                or r["caps_after"][0] == r["caps_before"]):
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: caps "
                             f"{r['caps_before']} -> {r['caps_after']}, the "
                             f"planner with the pod level's beta at inf "
                             f"gives {r['planner_caps_pod_beta_inf']}")
        if r["launches"] != want_rp:
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: launches "
                             f"{r['launches']}, the path needs {want_rp}")
        if len(r["losses"]) != REPLAN_STEPS or not all(
                math.isfinite(v) for v in r["losses"]):
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: losses "
                             f"{r['losses']}")
        got = r["losses"][r["first_replanned_step"]]
        plain = r["plain_first_replanned_loss"]
        r["first_replanned_rel_diff"] = rel = (
            math.inf if plain is None else abs(got - plain) / abs(plain))
        if not rel <= LOSS_RTOL:
            raise SystemExit(f"train_2x2_replan rank {r['rank']}: the first "
                             f"step after the replan logged loss {got} "
                             f"(kernels), the plain path gives {plain} from "
                             f"the same state: relative {rel} > "
                             f"{LOSS_RTOL}")
    print(rep[0]["log"], end="", flush=True)
    emit({"phase": "train_2x2_replan", "seconds": time.time() - t0,
          "world": list(WORLD_22), "backend": "gloo",
          "layers": REPLAN_LAYERS, "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_22, "steps": REPLAN_STEPS,
          "resilience": REPLAN_RESILIENCE, "chaos": REPLAN_CHAOS,
          "ranks": [{k: v for k, v in r.items() if k != "log"}
                    for r in rep]})

    # 13. training on the paper's three-level topology: eight ranks
    t0 = time.time()
    d222 = os.path.join(tmp, "2x2x2")
    os.makedirs(d222)
    sizes222 = mesh.mesh_from_topology(SPEC_222)
    mesh.spawn(train_rank, sizes222, "gloo", "cuda",
               args=(d222, TRAIN_BATCH_222, "a2a", "", TRAIN_STEPS,
                     TRAIN_222_LAYERS))
    r222 = []
    for r in range(math.prod(sizes222)):
        with open(os.path.join(d222, f"rank{r}.json")) as fh:
            r222.append(json.load(fh))
    for r in r222:
        if len(r["caps"]) != 3 or min(r["caps"]) <= 0 or any(
                len(fb) != 3 for fb in r["frac_by_level"]):
            raise SystemExit(f"train_2x2x2 rank {r['rank']}: caps "
                             f"{r['caps']}, frac_by_level "
                             f"{r['frac_by_level']}: not three levels")
    check_3 = check_training(
        r222, dict({k: TRAIN_222_LAYERS * TRAIN_STEPS for k in zero}, **off,
                   **{"moe_fused.local_moe": 0,
                      "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_2x2x2")
    emit({"phase": "train_2x2x2", "seconds": time.time() - t0,
          "topology": SPEC_222, "world": list(sizes222), "backend": "gloo",
          "layers": TRAIN_222_LAYERS, "depth_cut": "12 -> 6: eight ranks "
          "at 12 layers ran the card out of memory (9.15 GB a rank)",
          "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_222, "steps": TRAIN_STEPS, **check_3,
          "ranks": r222})

    # 14. data parallelism beside expert parallelism: a (3, 2) world
    t0 = time.time()
    ddp = os.path.join(tmp, "dp")
    os.makedirs(ddp)
    mesh.spawn(train_rank, WORLD_DP, "gloo", "cuda",
               args=(ddp, TRAIN_BATCH_DP, "a2a", "", TRAIN_STEPS, DP_LAYERS,
                     False, True))
    rdp = []
    for r in range(math.prod(WORLD_DP)):
        with open(os.path.join(ddp, f"rank{r}.json")) as fh:
            rdp.append(json.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)
    check_dp = check_training(
        rdp, dict({k: DP_LAYERS * TRAIN_STEPS for k in zero}, **off,
                  **{"moe_fused.local_moe": 0,
                     "moe_gemm.grouped_ffn_ragged_quant": 0}),
        "train_dp")
    for r in rdp:
        # pod 0's rank with this rank's data coordinate holds the same shard
        twin = rdp[r["coords"][1]]
        if r["experts_sha256"] != twin["experts_sha256"]:
            raise SystemExit(f"train_dp rank {r['rank']}: its expert leaves "
                             f"differ from their replica on rank "
                             f"{twin['rank']}")
    if rdp[0]["experts_sha256"] == rdp[1]["experts_sha256"]:
        raise SystemExit("train_dp: ranks 0 and 1 hold the same expert "
                         "leaves, not two shards")
    emit({"phase": "train_dp", "seconds": time.time() - t0,
          "world": list(WORLD_DP), "backend": "gloo",
          "ep_ranks": WORLD_DP[1], "dp_replicas": WORLD_DP[0],
          "layers": DP_LAYERS, "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH_DP, "steps": TRAIN_STEPS, **check_dp,
          "ranks": rdp})

    # 15. DeepSeek-V2-Lite at full width (MLA, top-6 of 64 experts,
    # swiglu) on one rank; every gpt3_medium_moe tensor of this process was
    # freed before serve_2x2
    ck_ds, srv_ds, tds = deepseek_phases(torch, np)

    # 16. kernels: launches summed over every main path and rank
    def total(name):
        return sum(sum(v) if isinstance(v, list) else v
                   for v in by_path(name).values())

    def by_path(name):
        return {"serve": serve_launches[name],
                "serve_2x2": [r["launches"][name] for r in srv],
                "train_1rank": one["launches"][name],
                "train_1rank_fused_xent": xent["launches"][name],
                "train_2x2": [r["launches"][name] for r in ranks],
                "train_2x2_pipelined": [r["launches"][name] for r in pipe],
                "train_einsum_k6": ein["launches"][name],
                "train_1rank_accum_remat": acc["launches"][name],
                "train_resilient": resil["launches"][name],
                "train_2x2_replan": [r["launches"][name] for r in rep],
                "train_2x2x2": [r["launches"][name] for r in r222],
                "train_dp": [r["launches"][name] for r in rdp],
                "serve_dsv2_lite": srv_ds["launches"][name],
                "train_dsv2_lite_d4": tds["launches"][name]}

    def dsv2_row(r, extra=()):
        """One DeepSeek-V2-Lite reading of checks_dsv2_lite."""
        return {n: r[n] for n in ("ms", "device_ms", "kernel_device_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_abs_err") + extra
                if n in r}

    def bwd_err(kernel):
        return max(v["max_abs_err"] for k, v in bwd.items()
                   if k == kernel or k.startswith(kernel + "_"))

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
         "backward_max_abs_err": bwd_err("K1"),
         **pair_row(k1),
         "dsv2_lite_2x2": dsv2_row(ck_ds["K1"], ("call_ms", "host_us"))},
        {"name": "moe_permute.unpermute", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_permute.cu",
         "replaces": "src/repro/kernels/moe_permute/kernel.py:88",
         "launches": total("moe_permute.unpermute"),
         "launches_by_path": by_path("moe_permute.unpermute"),
         "max_abs_err": max(e["max_abs_err"]
                            for e in list(k2.values()) + k2_edges
                            + [ck_ds["K2"]]),
         "backward_max_abs_err": bwd_err("K2"),
         **pair_row(k2),
         "dsv2_lite_2x2": dsv2_row(ck_ds["K2"], ("call_ms", "host_us"))},
        {"name": "moe_gemm.grouped_ffn_ragged", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:228",
         "launches": total("moe_gemm.grouped_ffn_ragged"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn_ragged"),
         "max_abs_err": max([k3["max_abs_err"], k3_222["max_abs_err"],
                             k_replan["K3_max_abs_err"],
                             k_222["K3_max_abs_err"],
                             ck_ds["K3"]["max_abs_err"]]
                            + [e["max_abs_err"] for e in k3e]),
         "backward_max_abs_err": bwd["K3"]["max_abs_err"],
         **{n: k3[n] for n in ("ms", "device_ms", "kernel_device_ms",
                               "call_ms", "host_us", "plain_ms", "bound_ms",
                               "bound_by", "tiles")},
         "library_ms": None,
         "layouts": {label: {n: r[n] for n in (
             "ms", "device_ms", "kernel_device_ms", "call_ms", "host_us",
             "plain_ms", "bound_ms", "bound_by", "tiles", "max_abs_err")}
             for label, r in (("2x2", k3), ("2x2x2", k3_222))},
         "dsv2_lite_2x2": dsv2_row(ck_ds["K3"], ("tiles", "valid_rows"))},
        {"name": "moe_gemm.grouped_ffn_ragged_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:312",
         "launches": total("moe_gemm.grouped_ffn_ragged_quant"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn_ragged_quant"),
         "max_abs_err": max(k7["max_abs_err"], k7_full["max_abs_err"],
                            ck_ds["K7"]["max_abs_err"]),
         "backward_max_abs_err": bwd["K7"]["max_abs_err"],
         "ms": k7["ms"], "device_ms": k7["device_ms"],
         "kernel_device_ms": k7["kernel_device_ms"],
         "quantize_ms": k7["quantize_ms"],
         "weights_quantize_ms": k7["weights_quantize_ms"],
         "weights_quantize_device_ms": k7["weights_quantize_device_ms"],
         "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None,
         "layouts": {"S=608": k7, "S=4864": k7_full},
         "dsv2_lite_chunk0": dsv2_row(ck_ds["K7"], ("chunks", "R",
                                                    "valid_rows"))},
        {"name": "moe_fused.local_moe", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_fused.cu",
         "replaces": "src/repro/kernels/moe_fused/kernel.py:123",
         "launches": total("moe_fused.local_moe"),
         "launches_by_path": by_path("moe_fused.local_moe"),
         "max_abs_err": max(e["max_abs_err"]
                            for e in list(k4.values()) + k4_edges
                            + list(ck_ds["K4"].values())),
         "backward_max_abs_err": bwd["K4"]["max_abs_err"],
         **{n: kp[n] for n in ("ms", "device_ms", "kernel_device_ms",
                               "call_ms", "host_us", "plain_ms", "bound_ms",
                               "bound_by", "computed_rows",
                               "weighted_rows")},
         "library_ms": None,
         "layouts": {label: {n: r[n] for n in (
             "ms", "device_ms", "kernel_device_ms", "call_ms", "host_us",
             "plain_ms", "bound_ms", "bound_by", "computed_rows",
             "weighted_rows", "dense_rows", "max_abs_err")}
             for label, r in k4.items()},
         "dsv2_lite_layouts": {
             label: dsv2_row(r, ("computed_rows", "weighted_rows",
                                 "dense_rows"))
             for label, r in ck_ds["K4"].items()}},
        {"name": "flash_attn.flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:65",
         "launches": total("flash_attn.flash_attention"),
         "launches_by_path": by_path("flash_attn.flash_attention"),
         "max_abs_err": max([k5["max_abs_err"], k5_512["max_abs_err"]]
                            + [e["max_abs_err"] for e in edges]),
         "ms": k5["ms"], "device_ms": k5["device_ms"],
         "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"],
         "library_device_ms": k5["library_device_ms"],
         "shapes": {"4x128x16x64": k5, "4x512x16x64": k5_512}},
        {"name": "moe_gemm.grouped_ffn", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm/kernel.py:185",
         "launches": total("moe_gemm.grouped_ffn"),
         "launches_by_path": by_path("moe_gemm.grouped_ffn"),
         "max_abs_err": max(e["max_abs_err"] for e in [k6] + k6_edges),
         "backward_max_abs_err": bwd["K6"]["max_abs_err"],
         "ms": k6["ms"], "device_ms": k6["device_ms"],
         "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
         "library_ms": None, "bmm_chain_ms": k6["bmm_chain_ms"],
         "bmm_chain_device_ms": k6["bmm_chain_device_ms"]},
        {"name": "decode_attn.decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn/kernel.py:65",
         "path": "none: no model calls it, as in the reference",
         "launches": total("decode_attn.decode_attention"),
         "launches_by_path": by_path("decode_attn.decode_attention"),
         "check_launches": sum(e["launches"] for e in [k8] + k8_edges),
         "max_abs_err": max(e["max_abs_err"] for e in [k8] + k8_edges),
         "ms": k8["ms"], "device_ms": k8["device_ms"],
         "plain_ms": k8["plain_ms"],
         "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
         "library_ms": k8["library_ms"],
         "library_device_ms": k8["library_device_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
