"""Times the kernels of several checkouts of this repo against each other on
one card.

    python3 chip_ab.py ROOT [ROOT ...]

For each ROOT, in the order given (to compare two commits, give the parent
and the change as ``parent change change parent``), a child process runs
with ROOT's package, whose kernels it builds from ROOT's own sources:

* K1 (``permute``) and K2 (``unpermute``) through ROOT's public entries,
  at two layouts of full-width gpt3_medium_moe that this script's own
  checkout builds once (with its ``chip_smoke.py``) and hands every root
  in one file, so every root reads the same inputs: rank 0 of the 2x2
  training plan (T = 1024, S = 4864) and chunk 0 of the pipelined int8
  plan (S = 608).  The kernel and its one-call library yardstick
  (``index_select``; ``embedding_bag`` over an f32 table) are read alike:
  ``device_ms`` (the card's time only), ``call_ms`` (CUDA events around
  calls made as the training path makes them: grad enabled, the inputs
  requiring grad), ``host_us`` (the host clock over the same calls with
  no synchronize inside: the enqueue cost), beside ``bound_ms``.
* K3 (``grouped_ffn_ragged``) on the staged 2x2 plan's rank-0 receive
  buffer (S = 4864) and K7 (``grouped_ffn_ragged_quant``) on chunk 0 of
  the pipelined int8 plan (S = 608), on the same saved inputs, each held
  against its plain version and read as training calls it (``device_ms``,
  ``call_ms``, ``host_us``, with ``kernel_device_ms`` the device time of
  the checkout's own kernels, told apart by the ``__global__`` names of
  its ``csrc/moe_gemm.cu``).  K7 is read in three parts: the whole call,
  the quantization one call runs (``quantize``) and, where the checkout
  quantizes each layer's expert weights once a forward
  (``quantize_expert_weights``), that quantization (``weights``);
  ``layer_device_ms`` sums a layer forward's eight calls and its weight
  quantization.
* K4 (``local_moe``) at its three layouts of full-width gpt3_medium_moe,
  built by this checkout's ``chip_smoke.gather_k4_case`` /
  ``train1_k4_case`` and saved with layer 0's expert weights: decode (8
  tokens), prefill (a 4 x 128 pack) and the one-rank training layout
  (2048 tokens), each held against ``local_moe_ref`` and read as training
  calls it (x, ``slot_w`` and the weights requiring grad), with
  ``kernel_device_ms`` its own launches, whether 5 calls on the layout
  give equal bits (``bit_equal_5_calls``) and, where the checkout has
  ``compact_slots``, the rows its FFN launches compute.
* K5 (``flash_attention``, causal) at the serve prefill shape [4, 128, 16,
  64] and at [4, 512, 16, 64], with its yardstick
  ``scaled_dot_product_attention`` read alike.
* K8 (``decode_attention``) at the decode_32k shapes (``K8_SHAPES``: 32
  requests of lengths drawn from a seed in [1, 32768], NaN past each, 16
  KV heads of 64 and 8 of 128), held against its plain version, with its
  yardstick ``scaled_dot_product_attention`` (a boolean length mask, on a
  copy of the cache with the NaN rows zeroed) read alike.
* K6 (``grouped_ffn``, gelu) on the einsum phase's [64, 128, 1024]
  capacity buffer (``chip_smoke.einsum_k6_case``, saved with the K4
  layouts' layer-0 weights), held against its plain version and read as
  training calls it (x and the weights requiring grad), with
  ``kernel_ms_by_launch`` (each of the checkout's launches by name) and
  the cuBLAS chain ``bmm`` -> ``gelu`` -> ``bmm`` read alike beside it.

Each run prints one JSON line with the root, the card (``nvidia-smi``'s
name and power limit) and each reading, with its error against the plain
version.  A last line (``interleaved``) takes ``host_us`` and ``call_ms``
of K1, K2, K5 (at [4, 128, 16, 64]), K4 (at the decode layout) and K8
(at the first of ``K8_SHAPES``) again
with every root's package loaded in one process and the roots read in
turns: the host is shared and drifts between processes by more than the
launch paths differ.  Exits non-zero if there is no card or any check
fails.

The reading functions below are ``chip_smoke.py``'s too.
"""

import functools
import gc
import math
import os
import re
import subprocess
import sys
import tempfile
import time

#: calls a reading averages over, and readings of the host-clocked times
#: the least is reported of
ITERS, REPEATS = 200, 11

LAYOUTS = r"""
import sys, torch
FFN_KEYS = ("xin", "rows_valid", "segs", "exps", "w_in", "w_out")
K4_KEYS = ("x", "tok", "w", "offs", "exps", "valid")
import chip_smoke as cs
from repro_torch.configs.base import get_config
from repro_torch.models import model as model_lib

arch = get_config(cs.ARCH_ID)
ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                          aux_mode="none", seq_len=cs.CACHE_LEN,
                          global_batch=cs.NUM_SLOTS)
params = model_lib.init_params(
    ctx, torch.Generator(device="cuda").manual_seed(0))
gen = torch.Generator(device="cuda").manual_seed(1)
with torch.no_grad():
    cases = {"S=4864": cs.staged_case(torch, params, arch, gen),
             "S=608": cs.pipelined_case(torch, params, arch, gen)}
out, ffn = {}, {}
for label, c in cases.items():
    di = c["di"]
    y = torch.randn((di.num_slots, c["x"].shape[1]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    out[label] = {"x": c["x"], "slot_to_token": di.slot_to_token,
                  "inv_idx": di.inv_idx, "inv_w": di.inv_w, "y": y}
    ffn[label] = {k: c[k] for k in FFN_KEYS}
with torch.no_grad():
    k4 = {"decode": cs.gather_k4_case(torch, params, ctx, cs.NUM_SLOTS, gen),
          "prefill": cs.gather_k4_case(torch, params, ctx,
                                       cs.PACK * cs.BUCKET, gen),
          "train_1rank": cs.train1_k4_case(torch, params, arch, gen)}
    x6, _, _, filled6 = cs.einsum_k6_case(torch, params, arch, gen)
cpu = lambda v: v.cpu() if torch.is_tensor(v) else v
p0 = params["layers"][0]["ffn"]
torch.save({"perm": {k: {n: cpu(t) for n, t in v.items()}
                     for k, v in out.items()},
            "ffn": {k: {n: cpu(t) for n, t in v.items()}
                    for k, v in ffn.items()},
            "fused": {k: {n: cpu(t) for n, t in zip(K4_KEYS, args[:6])}
                      for k, (args, _) in k4.items()},
            "fused_w": {"w_in": cpu(p0["w_in"]), "w_out": cpu(p0["w_out"])},
            "einsum": {"x": cpu(x6), "filled": filled6}},
           sys.argv[1])
"""

INTERLEAVED = r"""
import importlib.util, json, os, sys
import torch
import chip_smoke as cs

spec = importlib.util.spec_from_file_location("chip_ab_readings", sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
ops, flash, fused, decode = {}, {}, {}, {}
for root in sys.argv[3:]:
    # each checkout's package in turn; a module keeps its own globals once
    # it is loaded, so the earlier roots' entries go on working
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.join(root, "src"))
    ops[root] = importlib.import_module("repro_torch.kernels.moe_permute.ops")
    flash[root] = importlib.import_module("repro_torch.kernels.flash_attn.ops")
    fused[root] = importlib.import_module("repro_torch.kernels.moe_fused.ops")
    decode[root] = importlib.import_module(
        "repro_torch.kernels.decode_attn.ops")
    sys.path.pop(0)
saved = torch.load(sys.argv[2])
out = {label: ab.interleaved_readings(
           torch, ops, {k: v.cuda() for k, v in lay.items()}, cs.time_ms)
       for label, lay in saved["perm"].items()}
out["K5"] = ab.interleaved_flash(torch, flash, ab.K5_SHAPES[0], cs.time_ms)
out["K4_decode"] = ab.interleaved_fused(
    torch, fused, ab.fused_case(torch, saved, "decode"), cs.time_ms)
out["K8"] = ab.interleaved_decode(torch, decode, ab.K8_SHAPES[0], cs.time_ms)
print(json.dumps({"interleaved": out, "nvidia_smi": cs.nvidia_smi_line()}),
      flush=True)
"""

CHILD = r"""
import importlib.util, json, os, sys, time
root = os.getcwd()
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from repro_torch.kernels.decode_attn import ops as d_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.moe_fused import ops as f_ops
from repro_torch.kernels.moe_gemm import ops as g_ops
from repro_torch.kernels.moe_permute import ops as p_ops

spec = importlib.util.spec_from_file_location("chip_ab_readings", sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.time()
saved = torch.load(sys.argv[2])
perm = {}
for label, lay in saved["perm"].items():
    lay = {k: v.cuda() for k, v in lay.items()}
    perm[label] = {
        "K1": ab.permute_readings(torch, p_ops, lay["x"],
                                  lay["slot_to_token"], cs.time_ms,
                                  cs.bound_ms),
        "K2": ab.unpermute_readings(torch, p_ops, lay["y"], lay["inv_idx"],
                                    lay["inv_w"], cs.time_ms, cs.bound_ms,
                                    cs.K2_ATOL, cs.K2_RTOL)}
ffn = {label: {k: v.cuda() if torch.is_tensor(v) else v
               for k, v in c.items()} for label, c in saved["ffn"].items()}
k4 = {label: ab.fused_readings(
          torch, f_ops, ab.fused_case(torch, saved, label),
          ab.kernel_names(root, "moe_fused"), cs.time_ms, cs.bound_ms,
          cs.K4_ATOL, cs.K4_RTOL)
      for label in saved["fused"]}
ours = ab.kernel_names(root, "moe_gemm")
k6 = ab.k6_readings(torch, g_ops, ab.k6_case(torch, saved), ours,
                    cs.time_ms, cs.bound_ms, cs.K6_ATOL, cs.K6_RTOL)
del saved
k3 = ab.ragged_readings(torch, g_ops, ffn["S=4864"], ours, cs.time_ms,
                        cs.bound_ms, cs.K3_ATOL, cs.K3_RTOL)
k7 = ab.quant_readings(torch, g_ops, ffn["S=608"], ours, cs.time_ms,
                       cs.bound_ms, cs.K7_ATOL, cs.K7_RTOL)
del ffn
k5 = {"x".join(map(str, shape)): ab.flash_readings(
          torch, fa_ops, shape, ab.kernel_names(root, "flash_attn"),
          cs.time_ms, cs.bound_ms, cs.K5_ATOL, cs.K5_RTOL)
      for shape in ab.K5_SHAPES}
k8 = {"x".join(map(str, shape)): ab.decode_readings(
          torch, d_ops, shape, ab.kernel_names(root, "decode_attn"),
          cs.time_ms, cs.bound_ms, (cs.K8_ATOL, cs.K8_RTOL),
          (cs.K8_LIB_ATOL, cs.K8_LIB_RTOL))
      for shape in ab.K8_SHAPES}
out = {"root": root, "nvidia_smi": cs.nvidia_smi_line(),
       "seconds": time.time() - t0, "permute_pair": perm,
       "K4": k4, "K3": k3, "K7": k7, "K5": k5, "K6": k6, "K8": k8}
print(json.dumps(out), flush=True)
"""

#: K5's shapes [B, S, H, hd], causal: the serve prefill pack, and the
#: training sequence length (for information: training attends through the
#: plain ``_sdpa``)
K5_SHAPES = ((4, 128, 16, 64), (4, 512, 16, 64))
#: K8's shapes (B, L, H, K, hd): the decode_32k cache of gpt3_medium_moe's
#: heads and of the dense decoders' 8 KV heads of 128
K8_SHAPES = ((32, 32768, 16, 16, 64), (32, 32768, 16, 8, 128))


# ---------------------------------------------------------------------------
# K1 / K2 readings
# ---------------------------------------------------------------------------


#: profiler windows ``device_ms`` takes at most before it gives up
WINDOWS = 10


def device_ms(torch, fn, iters: int = ITERS):
    """The card's time of one call of ``fn``: the durations of every CUDA
    kernel, copy and memset that ``iters`` calls launch, summed by
    torch.profiler (no launch gaps), over ``iters``; and each device
    activity a call launches, by name: ``{name: (per call, ms a call)}``.
    The window follows a warm-up window of as many calls, since the tracer
    starts late.  A window in which an activity's count is not a whole
    number a call (the profiler drops a few events now and then on an
    H100, and once in three windows running at K4's decode reading; a
    whole smoke run once met five such windows in a row at one reading)
    is taken again, up to WINDOWS times in all."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # a range (the profiler's step, a record_function) also shows as a
        # device-side span under its host-side name; only kernels, copies
        # and memsets count
        averages = prof.key_averages()
        host = {e.key for e in averages if e.device_type.name == "CPU"}
        events = [e for e in averages
                  if e.device_type.name == "CUDA" and e.key not in host]
        if events and all(e.count % iters == 0 for e in events):
            return (sum(e.self_device_time_total for e in events) / 1e3
                    / iters,
                    {e.key: (e.count // iters,
                             e.self_device_time_total / 1e3 / iters)
                     for e in events})
    raise SystemExit(f"chip_ab: the profiler dropped device activity in "
                     f"{WINDOWS} windows")


def kernel_names(root: str, source: str) -> tuple:
    """The ``__global__`` functions of ROOT's ``csrc/<source>.cu``: the
    hand-written kernels, told apart from PyTorch's in a profile."""
    path = os.path.join(root, "src", "repro_torch", "csrc", f"{source}.cu")
    with open(path) as fh:
        text = fh.read()
    return tuple(sorted(set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
        text))))


def ours_ms(by_key: dict, names) -> float:
    """The device time a call spends in the kernels named ``names``."""
    return sum(ours_by_launch(by_key, names).values())


def ours_by_launch(by_key: dict, names) -> dict:
    """The device time a call spends in each kernel named ``names``, by
    its name (template arguments kept)."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names))
                     + r")\b(<[^>]*>)?")
    out = {}
    for key, (_, ms) in by_key.items():
        m = pat.search(key)
        if m:
            name = m.group(1) + (m.group(2) or "")
            out[name] = out.get(name, 0.0) + ms
    return out


def host_us(torch, fn, iters: int = ITERS) -> float:
    """The host clock over ``iters`` calls with no synchronize inside (the
    enqueue cost of one call), in microseconds; Python's collector held
    off meanwhile."""
    fn()
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = time.perf_counter() - t0
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return 1e6 * t / iters


def readings(torch, fn, time_ms, ours=()) -> dict:
    """``device_ms``, ``call_ms`` and ``host_us`` of ``fn``, every call
    made with grad enabled.  The host-clocked two are the least of
    REPEATS readings: the host is shared, and its neighbours only ever
    add time (their median and largest are kept beside).  With ``ours``
    (kernel names), ``kernel_device_ms`` is the device time of those
    kernels alone and ``kernel_ms_by_launch`` each one's."""
    with torch.enable_grad():
        dev, by_key = device_ms(torch, fn)
        calls = sorted(time_ms(torch, fn, ITERS) for _ in range(REPEATS))
        hosts = sorted(host_us(torch, fn) for _ in range(REPEATS))
    out = {"device_ms": dev,
           "device_launches": {k[:60]: n for k, (n, _) in by_key.items()},
           "call_ms": calls[0], "host_us": hosts[0],
           "call_ms_median_max": [calls[REPEATS // 2], calls[-1]],
           "host_us_median_max": [hosts[REPEATS // 2], hosts[-1]]}
    if ours:
        out["kernel_device_ms"] = ours_ms(by_key, ours)
        out["kernel_ms_by_launch"] = ours_by_launch(by_key, ours)
    return out


def permute_readings(torch, p_ops, x, tok, time_ms, bound_ms,
                     full: bool = True) -> dict:
    """K1 (``p_ops.permute``) on ``x`` [T, d] and ``slot_to_token`` ``tok``
    [S]: held bit for bit against its plain version, then read with
    :func:`readings` as ``engine.py`` calls it (``x`` requiring grad), and
    its yardstick ``index_select`` over ``x`` with the sentinel's zero row
    (requiring grad) alike; without ``full``, the kernel's ``device_ms``
    alone.  ``bound_ms`` counts the distinct tokens read, the indices and
    the rows written."""
    from repro_torch.kernels.moe_permute.ref import permute_ref
    T, d = x.shape
    S = tok.numel()
    xg = x.detach().clone().requires_grad_(True)
    x_pad = torch.cat([x, x.new_zeros((1, d))]).requires_grad_(True)
    idx = tok.long()

    def kernel():
        return p_ops.permute(xg, tok, use_pallas=True)

    def library():
        return x_pad.index_select(0, idx)

    with torch.no_grad():
        got, want, lib = kernel(), permute_ref(x, tok), library()
    if not (torch.equal(got, want) and torch.equal(lib, want)):
        raise SystemExit(f"K1 at S={S}: kernel or index_select disagrees "
                         f"with plain")
    used = int(torch.unique(tok[tok < T]).numel())
    esize = x.element_size()
    b_ms, b_by = bound_ms(used * d * esize + S * 4 + S * d * esize, 0.0)
    out = {"T": T, "S": S, "d": d, "tokens_read": used,
           "sentinel_slots": S - int((tok < T).sum()),
           "bound_ms": b_ms, "bound_by": b_by}
    if not full:
        with torch.enable_grad():
            return {**out, "device_ms": device_ms(torch, kernel)[0]}
    return {**out, **readings(torch, kernel, time_ms),
            "library": {"call": "index_select",
                        **readings(torch, library, time_ms)}}


def unpermute_readings(torch, p_ops, y, inv_idx, inv_w, time_ms, bound_ms,
                       atol, rtol, full: bool = True) -> dict:
    """K2 (``p_ops.unpermute``) on ``y`` [S, d] and ``inv_idx`` /
    ``inv_w`` [T, K]: held against its plain version (within ``atol`` +
    ``rtol``·|plain|), then read with :func:`readings` as ``engine.py``
    calls it (``y`` and ``inv_w`` requiring grad), and its yardstick
    ``embedding_bag`` (a weighted sum over an f32 table with the
    sentinel's zero row, built outside the readings) alike; without
    ``full``, the kernel's ``device_ms`` alone.  ``bound_ms``
    counts the weighted picks' rows, the index and weight pairs, the f32
    output and two operations a picked element."""
    from repro_torch.kernels.moe_permute.ref import unpermute_ref
    F = torch.nn.functional
    S, d = y.shape
    T, K = inv_idx.shape
    yg = y.detach().clone().requires_grad_(True)
    wg = inv_w.detach().clone().requires_grad_(True)
    y_pad = torch.cat([y, y.new_zeros((1, d))]).float().requires_grad_(True)
    idx = inv_idx.long()

    def kernel():
        return p_ops.unpermute(yg, inv_idx, wg, use_pallas=True)

    def library():
        return F.embedding_bag(idx, y_pad, per_sample_weights=wg,
                               mode="sum")

    with torch.no_grad():
        want = unpermute_ref(y, inv_idx, inv_w)
        tried = {"kernel": kernel()}
        if full:
            tried["embedding_bag"] = library()
    errs = {}
    for name, t in tried.items():
        err = (t - want).abs()
        if not bool((err <= atol + rtol * want.abs()).all()):
            raise SystemExit(f"K2 at S={S}: {name} disagrees with plain "
                             f"(max abs err {float(err.max())})")
        errs[name] = float(err.max())
    picks = int(((inv_idx < S) & (inv_w != 0)).sum())
    b_ms, b_by = bound_ms(picks * d * y.element_size() + T * K * 8
                          + T * d * 4, 2.0 * picks * d)
    out = {"T": T, "K": K, "S": S, "picks": picks,
           "max_abs_err": errs["kernel"], "atol": atol, "rtol": rtol,
           "bound_ms": b_ms, "bound_by": b_by}
    if not full:
        with torch.enable_grad():
            return {**out, "device_ms": device_ms(torch, kernel)[0]}
    return {**out, **readings(torch, kernel, time_ms),
            "library": {"call": "embedding_bag, f32 table",
                        "max_abs_err": errs["embedding_bag"],
                        **readings(torch, library, time_ms)}}


def interleaved_readings(torch, ops, lay, time_ms) -> dict:
    """``host_us`` and ``call_ms`` of K1 and K2 of every checkout in
    ``ops`` (root -> its ``moe_permute.ops``) on one layout ``lay``, called
    as :func:`readings` calls them, in REPEATS rounds that read each root
    once in turn; the least reading of each."""
    x = lay["x"].detach().clone().requires_grad_(True)
    y = lay["y"].detach().clone().requires_grad_(True)
    w = lay["inv_w"].detach().clone().requires_grad_(True)
    fns = {}
    for root, m in ops.items():
        fns[root, "K1"] = functools.partial(
            m.permute, x, lay["slot_to_token"], use_pallas=True)
        fns[root, "K2"] = functools.partial(
            m.unpermute, y, lay["inv_idx"], w, use_pallas=True)
    host, call = {}, {}
    with torch.enable_grad():
        for _ in range(REPEATS):
            for key, fn in fns.items():
                host[key] = min(host.get(key, math.inf), host_us(torch, fn))
                call[key] = min(call.get(key, math.inf),
                                time_ms(torch, fn, ITERS))
    return {k: {root: {"host_us": host[root, k], "call_ms": call[root, k]}
                for root in ops} for k in ("K1", "K2")}


def _held(torch, name, got, want, atol, rtol, dead=None) -> float:
    """Max abs error of ``got`` against ``want``; exits unless it is within
    ``atol`` + ``rtol``·|want| everywhere and the ``dead`` rows are exact
    zeros."""
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.float().abs()).all())
    if dead is not None:
        ok = ok and bool((got[dead] == 0).all())
    if not ok:
        raise SystemExit(f"{name}: disagrees with plain (max abs err "
                         f"{float(err.max())})")
    return float(err.max())


def _dead_rows(torch, segs, valid, R):
    offs = torch.as_tensor(segs, device=valid.device)
    rows = torch.arange(R, device=valid.device)
    seg_of = torch.searchsorted(offs[1:], rows, right=True)
    return (rows - offs[seg_of]) >= valid[seg_of].long()


def _ffn_bytes(case):
    """(valid rows, experts holding one, R, d, f) of a ragged FFN case."""
    valid, exps, w_in = case["rows_valid"], case["exps"], case["w_in"]
    per_expert = [0] * w_in.shape[0]
    for e, v in zip(exps, valid.tolist()):
        per_expert[e] += v
    R, d = case["xin"].shape
    return (int(valid.sum()), sum(v > 0 for v in per_expert), R, d,
            w_in.shape[2])


def ragged_readings(torch, g_ops, case, ours, time_ms, bound_ms, atol,
                    rtol) -> dict:
    """K3 (``g_ops.grouped_ffn_ragged``) on a staged receive buffer, held
    against its plain version, then read as training calls it (x and the
    weights requiring grad); ``kernel_device_ms`` is its launch pair's
    device time.  ``bound_ms`` as ``chip_smoke.check_k3``'s."""
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    xin, valid, segs, exps = (case[k] for k in ("xin", "rows_valid", "segs",
                                                "exps"))
    w_in, w_out = case["w_in"], case["w_out"]
    xg, wi, wo = (t.detach().clone().requires_grad_(True)
                  for t in (xin, w_in, w_out))

    def call():
        return g_ops.grouped_ffn_ragged(xg, segs, exps, valid, wi, None, wo,
                                        activation="gelu", use_pallas=True)

    with torch.no_grad():
        err = _held(torch, "K3", call(), grouped_ffn_ragged_ref(
            xin, segs, exps, valid, w_in, None, w_out, activation="gelu"),
            atol, rtol, _dead_rows(torch, segs, valid, xin.shape[0]))
    nvalid, active, R, d, f = _ffn_bytes(case)
    b_ms, b_by = bound_ms(nvalid * d * 2 + active * 2 * d * f * 2
                          + R * d * 2 + valid.numel() * 4,
                          2.0 * nvalid * 2 * d * f)
    return {"R": R, "valid_rows": nvalid, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by,
            **readings(torch, call, time_ms, ours)}


def quant_readings(torch, g_ops, case, ours, time_ms, bound_ms, atol,
                   rtol, chunks: int = 8) -> dict:
    """K7 (``g_ops.grouped_ffn_ragged_quant``) on one chunk of the
    pipelined int8 plan, read in three parts: ``call`` (the whole call as
    training makes it, under grad; with ``kernel_device_ms``, the launches
    alone), ``quantize`` (the plain-torch quantization one call runs) and,
    where the checkout quantizes each layer's expert weights once a
    forward (``quantize_expert_weights``), ``weights`` (that once-a-layer
    quantization).  ``layer_device_ms`` is a layer forward's device time
    over ``chunks`` calls: chunks x call, plus the weights once."""
    from repro_torch.kernels.moe_gemm import ref
    xin, valid, segs, exps = (case[k] for k in ("xin", "rows_valid", "segs",
                                                "exps"))
    w_in, w_out = case["w_in"], case["w_out"]
    xg, wi, wo = (t.detach().clone().requires_grad_(True)
                  for t in (xin, w_in, w_out))
    hoisted = hasattr(g_ops, "quantize_expert_weights")
    kw = {"qweights": g_ops.quantize_expert_weights(w_in, None)} \
        if hoisted else {}

    def call():
        return g_ops.grouped_ffn_ragged_quant(xg, segs, exps, valid, wi,
                                              None, wo, activation="gelu",
                                              use_pallas=True, **kw)

    def quantize():
        if hoisted:
            return ref.quantize_segments(xin, segs)
        return ref.quantize_segments(xin, segs), ref.quantize_experts(w_in)

    with torch.no_grad():
        err = _held(torch, "K7", call(), ref.grouped_ffn_ragged_quant_ref(
            xin, segs, exps, valid, w_in, None, w_out, activation="gelu"),
            atol, rtol, _dead_rows(torch, segs, valid, xin.shape[0]))
    nvalid, active, R, d, f = _ffn_bytes(case)
    b_ms, b_by = bound_ms(nvalid * d + active * (d * f + f * d * 2)
                          + R * d * 2, 2.0 * nvalid * f * d,
                          int8_ops=2.0 * nvalid * d * f)
    out = {"R": R, "valid_rows": nvalid, "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "hoisted": hoisted,
           "call": readings(torch, call, time_ms, ours),
           "quantize": readings(torch, quantize, time_ms)}
    layer = chunks * out["call"]["device_ms"]
    if hoisted:
        out["weights"] = readings(
            torch, lambda: g_ops.quantize_expert_weights(w_in, None),
            time_ms)
        layer += out["weights"]["device_ms"]
    out["layer_device_ms"] = layer
    return out


def k6_case(torch, saved) -> dict:
    """K6's saved einsum buffer and layer 0's weights on the card."""
    w = saved["fused_w"]
    return {"x": saved["einsum"]["x"].cuda(),
            "filled": saved["einsum"]["filled"],
            "w_in": w["w_in"].cuda(), "w_out": w["w_out"].cuda()}


def k6_readings(torch, g_ops, case, ours, time_ms, bound_ms, atol,
                rtol) -> dict:
    """K6 (``g_ops.grouped_ffn``, gelu) on the einsum phase's buffer, held
    against its plain version (its all-zero rows to exact zeros), then
    read as training calls it (x and the weights requiring grad), with
    ``kernel_device_ms`` and ``kernel_ms_by_launch`` its own launches; and
    the cuBLAS chain ``bmm`` -> ``gelu`` -> ``bmm`` (three calls, so no
    one-call yardstick) checked and read alike.  ``bound_ms`` as
    ``chip_smoke.check_k6``'s: x and y once, the 64 experts' w_in and
    w_out, and the operations of the filled rows."""
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ref
    F = torch.nn.functional
    x, w_in, w_out = case["x"], case["w_in"], case["w_out"]
    E, C, d = x.shape
    f = w_in.shape[2]
    xg, wi, wo = (t.detach().clone().requires_grad_(True)
                  for t in (x, w_in, w_out))

    def call():
        return g_ops.grouped_ffn(xg, wi, None, wo, activation="gelu")

    def chain():
        return torch.bmm(F.gelu(torch.bmm(xg, wi), approximate="tanh"), wo)

    with torch.no_grad():
        want = grouped_ffn_ref(x, w_in, None, w_out, activation="gelu")
        err = _held(torch, "K6", call(), want, atol, rtol,
                    (x == 0).all(-1))
        chain_err = _held(torch, "bmm chain", chain(), want, atol, rtol)
    b_ms, b_by = bound_ms(2 * E * C * d * 2 + 2 * E * d * f * 2,
                          2.0 * case["filled"] * 2 * d * f)
    return {"shape": [E, C, d], "f": f, "filled_rows": case["filled"],
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            **readings(torch, call, time_ms, ours),
            "bmm_chain": {"max_abs_err": chain_err,
                          **readings(torch, chain, time_ms)}}


def fused_case(torch, saved, label) -> dict:
    """One K4 layout of the layouts file on the card: ``args`` in
    ``local_moe``'s order (gelu, layer 0's weights)."""
    c = {k: v.cuda() if torch.is_tensor(v) else v
         for k, v in saved["fused"][label].items()}
    w = saved["fused_w"]
    return {"label": label,
            "args": (c["x"], c["tok"], c["w"], tuple(c["offs"]),
                     tuple(c["exps"]), c["valid"], w["w_in"].cuda(), None,
                     w["w_out"].cuda())}


def fused_bound(torch, args, bound_ms):
    """K4's ``(bound_ms, bound_by, rows)`` on one layout: the bytes of the
    tokens, the slot maps and counts, the [T, d] f32 output and the
    weights of the experts that hold valid rows, and the operations of the
    rows with a nonzero combine weight (the work the output needs);
    ``rows`` counts those, the rows below the counts (what a dense tiling
    computes) and the active experts."""
    x, tok, w, offs, exps, valid, w_in, _, _ = args
    T, d = x.shape
    f = w_in.shape[2]
    weighted = int((w != 0).sum())
    active = len({e for e, v in zip(exps, valid.tolist()) if v > 0})
    nbytes = (T * d * 2 + tok.numel() * 4 + w.numel() * 4 + len(exps) * 4
              + active * 2 * d * f * 2 + T * d * 4)
    b_ms, b_by = bound_ms(nbytes, 2 * weighted * 2 * d * f)
    return b_ms, b_by, {"weighted_rows": weighted,
                        "dense_rows": int(valid.sum()),
                        "active_experts": active}


def fused_readings(torch, f_ops, case, ours, time_ms, bound_ms, atol,
                   rtol) -> dict:
    """K4 (``f_ops.local_moe``, gelu) on one saved layout, held against its
    plain version, then read as training calls it (x, ``slot_w`` and the
    weights requiring grad); ``kernel_device_ms`` is the device time of
    its own launches.  ``computed_rows`` (where the checkout has
    ``compact_slots``): the rows its FFN launches compute."""
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    args = case["args"]
    x, tok, w, offs, exps, valid, w_in, _, w_out = args
    xg, wg, wi, wo = (t.detach().clone().requires_grad_(True)
                      for t in (x, w, w_in, w_out))

    def call():
        return f_ops.local_moe(xg, tok, wg, offs, exps, valid, wi, None, wo,
                               activation="gelu", use_pallas=True)

    with torch.no_grad():
        got = call()
        err = _held(torch, f"K4 {case['label']}", got,
                    local_moe_ref(*args, activation="gelu"), atol, rtol)
        same = all(torch.equal(got, call()) for _ in range(4))
        computed = (int(f_ops.compact_slots(tok, w, offs, valid,
                                            x.shape[0])[1].sum())
                    if hasattr(f_ops, "compact_slots") else None)
    b_ms, b_by, rows = fused_bound(torch, args, bound_ms)
    return {"T": x.shape[0], "slots": tok.numel(), "segments": len(exps),
            "computed_rows": computed, **rows, "max_abs_err": err,
            "bit_equal_5_calls": same, "bound_ms": b_ms, "bound_by": b_by,
            **readings(torch, call, time_ms, ours)}


def interleaved_fused(torch, ops, case, time_ms) -> dict:
    """``host_us`` and ``call_ms`` of K4 of every checkout in ``ops``
    (root -> its ``moe_fused.ops``) on one saved layout, called as
    :func:`fused_readings` calls it, read in turns as
    :func:`interleaved_readings` reads K1 and K2."""
    x, tok, w, offs, exps, valid, w_in, _, w_out = case["args"]
    xg, wg, wi, wo = (t.detach().clone().requires_grad_(True)
                      for t in (x, w, w_in, w_out))
    host, call = {}, {}
    with torch.enable_grad():
        for _ in range(REPEATS):
            for root, m in ops.items():
                fn = functools.partial(m.local_moe, xg, tok, wg, offs, exps,
                                       valid, wi, None, wo,
                                       activation="gelu", use_pallas=True)
                host[root] = min(host.get(root, math.inf),
                                 host_us(torch, fn))
                call[root] = min(call.get(root, math.inf),
                                 time_ms(torch, fn, ITERS))
    return {root: {"host_us": host[root], "call_ms": call[root]}
            for root in ops}


def flash_inputs(torch, shape):
    gen = torch.Generator(device="cuda").manual_seed(2)
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(3))


def flash_readings(torch, fa_ops, shape, ours, time_ms, bound_ms, atol,
                   rtol) -> dict:
    """K5 (``fa_ops.flash_attention``, causal) at ``shape`` [B, S, H, hd]
    and its yardstick ``scaled_dot_product_attention`` (on the same tensors
    viewed [B, H, S, hd]), both held against the plain version and read
    alike.  ``bound_ms`` counts q, k, v and o once and the causal pairs'
    two products."""
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    F = torch.nn.functional
    B, S, H, hd = shape
    q, k, v = flash_inputs(torch, shape)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return fa_ops.flash_attention(q, k, v, causal=True, use_pallas=True)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    with torch.no_grad():
        want = flash_attention_ref(q, k, v, causal=True)
        err = _held(torch, f"K5 {shape}", kernel(), want, atol, rtol)
        lib_err = _held(torch, f"SDPA {shape}", library().transpose(1, 2),
                        want, atol, rtol)
    b_ms, b_by = bound_ms(4 * B * S * H * hd * 2,
                          2 * 2 * B * H * hd * S * (S + 1) // 2)
    return {"shape": list(shape), "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by, **readings(torch, kernel, time_ms, ours),
            "library": {"call": "scaled_dot_product_attention",
                        "max_abs_err": lib_err,
                        **readings(torch, library, time_ms)}}


def interleaved_flash(torch, ops, shape, time_ms) -> dict:
    """``host_us`` and ``call_ms`` of K5 of every checkout in ``ops``
    (root -> its ``flash_attn.ops``) at ``shape``, read in turns as
    :func:`interleaved_readings` reads K1 and K2."""
    q, k, v = flash_inputs(torch, shape)
    host, call = {}, {}
    with torch.enable_grad():
        for _ in range(REPEATS):
            for root, m in ops.items():
                fn = functools.partial(m.flash_attention, q, k, v,
                                       causal=True, use_pallas=True)
                host[root] = min(host.get(root, math.inf),
                                 host_us(torch, fn))
                call[root] = min(call.get(root, math.inf),
                                 time_ms(torch, fn, ITERS))
    return {root: {"host_us": host[root], "call_ms": call[root]}
            for root in ops}


def decode_inputs(torch, shape):
    """K8's inputs at ``shape`` (B, L, H, K, hd), from seed 3: bf16 q and
    a k/v cache with NaN in every row past its request's length, lengths
    in [1, L] with one at L and one at 1; and the [B, L] valid rows."""
    B, L, H, K, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    lens = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
    lens[0], lens[1] = L, 1
    lens = lens.to(torch.int32)
    q = torch.randn((B, H, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, L, K, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    valid = torch.arange(L, device="cuda")[None, :] < lens[:, None].long()
    k[~valid], v[~valid] = float("nan"), float("nan")
    return q, k, v, lens, valid


def decode_readings(torch, d_ops, shape, ours, time_ms, bound_ms, tol,
                    lib_tol) -> dict:
    """K8 (``d_ops.decode_attention``) at ``shape`` (B, L, H, K, hd) on
    :func:`decode_inputs`, held against its plain version (within
    ``tol`` = (atol, rtol)), and its yardstick
    ``scaled_dot_product_attention`` (a boolean length mask, on a copy of
    the cache with the NaN rows zeroed; within ``lib_tol``), each read
    with :func:`readings`.  ``bound_ms`` counts the valid rows' k and v,
    q, the lengths and the output once, and two products of hd a valid
    row and query head."""
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    F = torch.nn.functional
    B, L, H, K, hd = shape
    q, k, v, lens, valid = decode_inputs(torch, shape)
    kc, vc = (torch.where(valid[:, :, None, None], t, 0).transpose(1, 2)
              for t in (k, v))
    mask = valid[:, None, None, :]

    def kernel():
        return d_ops.decode_attention(q, k, v, lens)

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask,
            enable_gqa=K != H)[:, :, 0]

    with torch.no_grad():
        want = decode_attention_ref(q, k, v, lens)
        err = _held(torch, f"K8 {shape}", kernel(), want, *tol)
        lib_err = _held(torch, f"SDPA {shape}", library(), want, *lib_tol)
    rows = int(valid.sum())
    b_ms, b_by = bound_ms(rows * K * hd * 2 * 2 + 2 * B * H * hd * 2 + B * 4,
                          4.0 * rows * H * hd)
    return {"shape": list(shape), "valid_rows": rows, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by,
            **readings(torch, kernel, time_ms, ours),
            "library": {"call": "scaled_dot_product_attention",
                        "max_abs_err": lib_err,
                        **readings(torch, library, time_ms)}}


def interleaved_decode(torch, ops, shape, time_ms) -> dict:
    """``host_us`` and ``call_ms`` of K8 of every checkout in ``ops``
    (root -> its ``decode_attn.ops``) at ``shape`` on
    :func:`decode_inputs`, read in turns as :func:`interleaved_readings`
    reads K1 and K2."""
    q, k, v, lens, _ = decode_inputs(torch, shape)
    host, call = {}, {}
    for _ in range(REPEATS):
        for root, m in ops.items():
            fn = functools.partial(m.decode_attention, q, k, v, lens)
            host[root] = min(host.get(root, math.inf), host_us(torch, fn))
            call[root] = min(call.get(root, math.inf),
                             time_ms(torch, fn, ITERS))
    return {root: {"host_us": host[root], "call_ms": call[root]}
            for root in ops}


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        if not os.path.exists(os.path.join(root, "chip_smoke.py")):
            print(f"chip_ab: {root} holds no chip_smoke.py", file=sys.stderr)
            return 2
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_ab_") as tmp:
        layouts = os.path.join(tmp, "layouts.pt")
        me = os.path.abspath(__file__)
        distinct = list(dict.fromkeys(os.path.abspath(r) for r in roots))
        runs = ([(here, [LAYOUTS, layouts])]
                + [(root, [CHILD, me, layouts]) for root in roots]
                + [(here, [INTERLEAVED, me, layouts, *distinct])])
        for cwd, args in runs:
            proc = subprocess.run([sys.executable, "-c", *args],
                                  cwd=os.path.abspath(cwd),
                                  capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or (args[0] is not LAYOUTS
                                        and not lines):
                sys.stderr.write(proc.stderr[-4000:])
                print(f"chip_ab: the run in {cwd} failed (exit "
                      f"{proc.returncode})", file=sys.stderr)
                return 1
            if args[0] is not LAYOUTS:
                print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
