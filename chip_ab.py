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
* K3 (``grouped_ffn_ragged``), K7 (``grouped_ffn_ragged_quant``) and,
  where the checkout has it, K6 (``grouped_ffn``) through ROOT's
  ``chip_smoke.py`` checks, on the same seeded inputs: the staged 2x2
  plan's rank-0 buffer, the pipelined int8 plan's chunk and the einsum
  phase's [64, 128, 1024] buffer.

Each run prints one JSON line with the root, the card (``nvidia-smi``'s
name and power limit) and each reading, with its error against the plain
version.  A last line (``interleaved``) takes ``host_us`` and ``call_ms``
of K1 and K2 again with every root's package loaded in one process and
the roots read in turns: the host is shared and drifts between processes
by more than the launch paths differ.  Exits non-zero if there is no card
or any check fails.

The K1/K2 reading functions below are ``chip_smoke.py``'s too.
"""

import functools
import gc
import math
import os
import subprocess
import sys
import tempfile
import time

#: calls a reading averages over, and readings of the host-clocked times
#: the least is reported of
ITERS, REPEATS = 200, 11

LAYOUTS = r"""
import sys, torch
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
out = {}
for label, c in cases.items():
    di = c["di"]
    y = torch.randn((di.num_slots, c["x"].shape[1]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    out[label] = {"x": c["x"], "slot_to_token": di.slot_to_token,
                  "inv_idx": di.inv_idx, "inv_w": di.inv_w, "y": y}
torch.save({k: {n: t.cpu() for n, t in v.items()} for k, v in out.items()},
           sys.argv[1])
"""

INTERLEAVED = r"""
import importlib.util, json, os, sys
import torch
import chip_smoke as cs

spec = importlib.util.spec_from_file_location("chip_ab_readings", sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
ops = {}
for root in sys.argv[3:]:
    # each checkout's package in turn; a module keeps its own globals once
    # it is loaded, so the earlier roots' entries go on working
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.join(root, "src"))
    ops[root] = importlib.import_module("repro_torch.kernels.moe_permute.ops")
    sys.path.pop(0)
out = {label: ab.interleaved_readings(
           torch, ops, {k: v.cuda() for k, v in lay.items()}, cs.time_ms)
       for label, lay in torch.load(sys.argv[2]).items()}
print(json.dumps({"interleaved": out, "nvidia_smi": cs.nvidia_smi_line()}),
      flush=True)
"""

CHILD = r"""
import importlib.util, json, os, sys, time
root = os.getcwd()
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from repro_torch.configs.base import get_config
from repro_torch.kernels.moe_permute import ops as p_ops
from repro_torch.models import model as model_lib

spec = importlib.util.spec_from_file_location("chip_ab_readings", sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.time()
perm = {}
for label, lay in torch.load(sys.argv[2]).items():
    lay = {k: v.cuda() for k, v in lay.items()}
    perm[label] = {
        "K1": ab.permute_readings(torch, p_ops, lay["x"],
                                  lay["slot_to_token"], cs.time_ms,
                                  cs.bound_ms),
        "K2": ab.unpermute_readings(torch, p_ops, lay["y"], lay["inv_idx"],
                                    lay["inv_w"], cs.time_ms, cs.bound_ms,
                                    cs.K2_ATOL, cs.K2_RTOL)}
arch = get_config(cs.ARCH_ID)
ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                          aux_mode="none", seq_len=cs.CACHE_LEN,
                          global_batch=cs.NUM_SLOTS)
params = model_lib.init_params(
    ctx, torch.Generator(device="cuda").manual_seed(0))
gen = torch.Generator(device="cuda").manual_seed(1)
with torch.no_grad():
    k3 = cs.check_k3(torch, cs.staged_case(torch, params, arch, gen))
    k7 = cs.check_k7(torch, cs.pipelined_case(torch, params, arch, gen))
    k6 = None
    if hasattr(cs, "check_k6"):
        x6, w_in6, w_out6, filled = cs.einsum_k6_case(torch, params, arch,
                                                      gen)
        k6 = cs.check_k6(torch, x6, w_in6, None, w_out6, "einsum", filled)
keys = ("ms", "plain_ms", "bound_ms", "max_abs_err")
out = {"root": root, "nvidia_smi": cs.nvidia_smi_line(),
       "seconds": time.time() - t0, "permute_pair": perm,
       "K3": {k: k3[k] for k in keys},
       "K7": {k: k7[k] for k in keys + ("quantize_ms",)}}
if k6 is not None:
    out["K6"] = {k: k6[k] for k in keys + ("bmm_chain_ms",)}
print(json.dumps(out), flush=True)
"""


# ---------------------------------------------------------------------------
# K1 / K2 readings
# ---------------------------------------------------------------------------


def device_ms(torch, fn, iters: int = ITERS):
    """The card's time of one call of ``fn``: the durations of every CUDA
    kernel, copy and memset that ``iters`` calls launch, summed by
    torch.profiler (no launch gaps), over ``iters``; and the device
    activities a call launches, by name.  The window follows a warm-up
    window of as many calls, since the tracer starts late.  A window in
    which an activity's count is not a whole number a call (the profiler
    drops a few events now and then on an H100) is taken again, up to
    three times in all."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # the step's own range also shows as a device-side span
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and not e.key.startswith("ProfilerStep")]
        if events and all(e.count % iters == 0 for e in events):
            return (sum(e.self_device_time_total for e in events) / 1e3
                    / iters, {e.key[:60]: e.count // iters for e in events})
    raise SystemExit("chip_ab: the profiler dropped device activity in "
                     "three windows")


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


def readings(torch, fn, time_ms) -> dict:
    """``device_ms``, ``call_ms`` and ``host_us`` of ``fn``, every call
    made with grad enabled.  The host-clocked two are the least of
    REPEATS readings: the host is shared, and its neighbours only ever
    add time (their median and largest are kept beside)."""
    with torch.enable_grad():
        dev, launched = device_ms(torch, fn)
        calls = sorted(time_ms(torch, fn, ITERS) for _ in range(REPEATS))
        hosts = sorted(host_us(torch, fn) for _ in range(REPEATS))
    return {"device_ms": dev, "device_launches": launched,
            "call_ms": calls[0], "host_us": hosts[0],
            "call_ms_median_max": [calls[REPEATS // 2], calls[-1]],
            "host_us_median_max": [hosts[REPEATS // 2], hosts[-1]]}


def permute_readings(torch, p_ops, x, tok, time_ms, bound_ms) -> dict:
    """K1 (``p_ops.permute``) on ``x`` [T, d] and ``slot_to_token`` ``tok``
    [S]: held bit for bit against its plain version, then read with
    :func:`readings` as ``engine.py`` calls it (``x`` requiring grad), and
    its yardstick ``index_select`` over ``x`` with the sentinel's zero row
    (requiring grad) alike.  ``bound_ms`` counts the distinct tokens read,
    the indices and the rows written."""
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
    return {"T": T, "S": S, "d": d, "tokens_read": used,
            "sentinel_slots": S - int((tok < T).sum()),
            "bound_ms": b_ms, "bound_by": b_by,
            **readings(torch, kernel, time_ms),
            "library": {"call": "index_select",
                        **readings(torch, library, time_ms)}}


def unpermute_readings(torch, p_ops, y, inv_idx, inv_w, time_ms, bound_ms,
                       atol, rtol) -> dict:
    """K2 (``p_ops.unpermute``) on ``y`` [S, d] and ``inv_idx`` /
    ``inv_w`` [T, K]: held against its plain version (within ``atol`` +
    ``rtol``·|plain|), then read with :func:`readings` as ``engine.py``
    calls it (``y`` and ``inv_w`` requiring grad), and its yardstick
    ``embedding_bag`` (a weighted sum over an f32 table with the
    sentinel's zero row, built outside the readings) alike.  ``bound_ms``
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
        got, want, lib = kernel(), unpermute_ref(y, inv_idx, inv_w), \
            library()
    errs = {}
    for name, t in (("kernel", got), ("embedding_bag", lib)):
        err = (t - want).abs()
        if not bool((err <= atol + rtol * want.abs()).all()):
            raise SystemExit(f"K2 at S={S}: {name} disagrees with plain "
                             f"(max abs err {float(err.max())})")
        errs[name] = float(err.max())
    picks = int(((inv_idx < S) & (inv_w != 0)).sum())
    b_ms, b_by = bound_ms(picks * d * y.element_size() + T * K * 8
                          + T * d * 4, 2.0 * picks * d)
    return {"T": T, "K": K, "S": S, "picks": picks,
            "max_abs_err": errs["kernel"], "atol": atol, "rtol": rtol,
            "bound_ms": b_ms, "bound_by": b_by,
            **readings(torch, kernel, time_ms),
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
