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
   card in bf16 at the full-width shapes the serve phase gives it: the
   fused local-MoE kernel (K4) at the decode layout (8 slots x 64
   experts) and the prefill layout (4 x 128 tokens x 64 experts), flash
   attention (K5) at the prefill shape [4, 128, 16, 64] (plus ragged and
   windowed edge shapes), with kernel, plain, bound and library times;
4. serve   — gpt3_medium_moe at full width (12 layers, d=1024, 64
   experts top-2, vocab 50304, bf16, random weights from a seed) through
   ``ServingEngine.run``: 8 requests, 8 slots, packs of 4, prompt bucket
   128, cache 256.  Checks every stream's budget and vocabulary, that the
   launch counters show every MoE layer of every step went through K4 and
   every prefill attention through K5, and that on a small input the
   kernel path is as close to a float32 plain run as the bf16 plain path;
5. profile — host-clock step times and a torch.profiler breakdown
   (device busy share, top kernels) of one prefill pack and one decode
   step;
6. kernels — one ``{"kernels": [...]}`` line.

Any failed phase raises (exit code non-zero).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

ARCH_ID = "gpt3_medium_moe"
NUM_SLOTS, PACK, BUCKET, CACHE_LEN = 8, 4, 128, 256
NUM_REQUESTS = 8
# H100 SXM published dense peaks (NVIDIA data sheet), used for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
# kernel vs plain tolerances in bf16: |kernel - plain| <= ATOL + RTOL*|plain|.
# K4: the plain version rounds each expert row to bf16 before the weighted
# combine (the kernel combines its f32 accumulator), and f32 sums run in
# another order (atomics in the kernel): a few bf16 ulps of |y| ~ 1.
K4_ATOL, K4_RTOL = 3e-2, 2e-2
# K5: both run in f32 and round the output to bf16 once: one bf16 ulp.
K5_ATOL, K5_RTOL = 1e-2, 1e-2
# end to end after 12 bf16 layers, relative Frobenius error of the logits
# against a float32 plain run: the kernel path may be at most E2E_RATIO
# times as far from it as the plain bf16 path (both differ from float32 by
# bf16 rounding, which random-weight layers amplify), or E2E_FLOOR
E2E_RATIO, E2E_FLOOR = 1.5, 1e-2


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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_k4(torch, params, ctx, Tg: int, gen, label: str, swiglu=False,
             timed=True):
    """K4 at the gather path's slot layout for Tg tokens of layer 0.  With
    ``swiglu`` (not gpt3_medium_moe's activation) a random gate
    projection is added, to hold the kernel's swiglu branch too."""
    from repro_torch.core import gating
    from repro_torch.core.dispatch import routing, transport
    from repro_torch.kernels.moe_fused import ops as fused_ops
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    p = params["layers"][0]["ffn"]
    d, E = ctx.arch.d_model, ctx.arch.moe.num_experts
    f = ctx.arch.moe.d_ff_expert
    x = torch.randn((Tg, d), generator=gen, device="cuda").to(torch.bfloat16)
    gate_out = gating.gate_forward(p["gate"], x, ctx.gate_cfg)
    tok, w, valid = routing.gather_slots(gate_out, 0, E)
    offs = transport.expert_segments(E, Tg)
    exps = tuple(range(E))
    w_gate, act = None, "gelu"
    if swiglu:
        w_gate = (torch.randn(p["w_in"].shape, generator=gen, device="cuda")
                  * d ** -0.5).to(torch.bfloat16)
        act = "swiglu"
    args = (x, tok, w, offs, exps, valid, p["w_in"], w_gate, p["w_out"])

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
    # combine weight (Tg * top_k), and the weights of the experts they pick.
    # The dense gather layout computes every row of a picked expert's
    # segment (computed_rows); the rows past weighted_rows are wasted work.
    computed_rows = int(valid.sum())
    weighted_rows = int((w != 0).sum())
    active = int((valid > 0).sum())
    nbytes = (Tg * d * 2 + tok.numel() * 4 + w.numel() * 4 + E * 4
              + active * 2 * d * f * 2 + Tg * d * 4)
    flops = 2 * weighted_rows * 2 * d * f
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"layout": label, "Tg": Tg, "slots": tok.numel(),
            "active_experts": active, "computed_rows": computed_rows,
            "weighted_rows": weighted_rows, "max_abs_err": err,
            "atol": K4_ATOL, "rtol": K4_RTOL, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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
        k4 = {"decode": check_k4(torch, params, ctx, NUM_SLOTS, gen,
                                 "decode"),
              "prefill": check_k4(torch, params, ctx, PACK * BUCKET, gen,
                                  "prefill")}
        k4_edges = [check_k4(torch, params, ctx, Tg, gen, label,
                             swiglu=True, timed=False)
                    for Tg, label in ((NUM_SLOTS, "decode"), (100, "ragged"))]
        hd = arch.head_dim_
        k5 = check_k5(torch, (PACK, BUCKET, arch.num_heads, hd), gen)
        edges = [check_k5(torch, (2, 100, arch.num_heads, hd), gen,
                          timed=False),
                 check_k5(torch, (1, 77, 4, hd), gen, window=16,
                          timed=False),
                 check_k5(torch, (1, 50, 4, hd), gen, causal=False,
                          timed=False)]
    emit({"phase": "checks", "K4": k4, "K4_edges": k4_edges, "K5": k5,
          "K5_edges": edges})

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

    # 5. kernels
    kp = k4["prefill"]
    emit({"kernels": [
        {"name": "moe_fused.local_moe", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_fused.cu",
         "replaces": "src/repro/kernels/moe_fused/kernel.py:123",
         "launches": launches["moe_fused.local_moe"],
         "max_abs_err": max([k4["decode"]["max_abs_err"], kp["max_abs_err"]]
                            + [e["max_abs_err"] for e in k4_edges]),
         "ms": kp["ms"], "plain_ms": kp["plain_ms"],
         "bound_ms": kp["bound_ms"], "bound_by": kp["bound_by"],
         "library_ms": None, "layouts": k4},
        {"name": "flash_attn.flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:65",
         "launches": launches["flash_attn.flash_attention"],
         "max_abs_err": max([k5["max_abs_err"]]
                            + [e["max_abs_err"] for e in edges]),
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
