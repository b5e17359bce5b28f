"""Reads K8 (the split-KV decode attention of ``csrc/decode_attn.cu``) in
other launch geometries than the one the port runs, on one card.

    python3 chip_k8_tune.py

``decode_attn.cu`` fixes K8's split launch in four constants: ``STAGES``
(a warp's ``cp.async`` ring depth), ``SCORE_DIMS`` (the dims of a cache
row one lane scores, which sets a step's rows and a stage's bytes),
``SPLIT_ROWS`` (cache rows a block) and ``NWARPS`` (warps a block).  For
each row of
``VARIANTS`` this script writes a copy of the source with those values
(``loads_only``: with a step's arithmetic taken out, so the warps only
stream their copies through the ring), builds them all at once (one nvcc
each, into the gitignored ``build/k8_tune/``), and at both decode_32k
shapes (``chip_ab.K8_SHAPES`` on ``chip_ab.decode_inputs``) holds each
(but the loads-only ones) against ``decode_attention_ref`` at
``chip_smoke.K8_ATOL, K8_RTOL`` and reads its time a call by CUDA events,
the variants in turns over ROUNDS rounds (the median), beside
``bound_ms``.  Prints one JSON line a build (ptxas's registers and spills,
dynamic shared bytes and resident blocks an SM of the split launch at
each shape) and one a shape.  Exits non-zero without a card, when the
source no longer holds a line it rewrites, or when a variant fails to
build, launch or agree.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

#: name -> constants of csrc/decode_attn.cu rewritten ("loads_only": the
#: step's scores, softmax and p v taken out)
VARIANTS = {
    "port": {},
    "stages4": {"STAGES": 4},
    "score64_stages2": {"SCORE_DIMS": 64, "STAGES": 2},
    "score64": {"SCORE_DIMS": 64},
    "split256": {"SPLIT_ROWS": 256},
    "split1024": {"SPLIT_ROWS": 1024},
    "warps2": {"NWARPS": 2},
    "loads_only": {"loads_only": True},
}
ROUNDS, CALLS = 5, 20

STEP_BEGIN = "    // scores: this lane's part of its row against each query head"
STEP_END = "  cp_async_wait<0>();\n  __syncwarp();\n"
#: a use of the landed stage, so the copies stay in the program
STEP_STUB = ("    if (valid && ks[0] == bf16(12345.0f)) o[0][0] += 1.0f;\n"
             "  }\n")


def variant_source(text: str, consts: dict) -> str:
    for name, value in consts.items():
        if name == "loads_only":
            a, b = text.index(STEP_BEGIN), text.index(STEP_END)
            text = text[:a] + STEP_STUB + text[b:]
            continue
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"chip_k8_tune: decode_attn.cu holds no "
                             f"`constexpr int {name} = ...;`")
    return text


def build_all(out_dir: str) -> dict:
    from repro_torch.kernels import backend
    csrc = os.path.join(REPO, "src", "repro_torch", "csrc")
    with open(os.path.join(csrc, "decode_attn.cu")) as fh:
        text = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, consts in VARIANTS.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(variant_source(text, consts))
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [backend._nvcc(), *backend.NVCC_FLAGS, "-I", csrc, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_k8_tune: {name} failed to build:\n"
                             f"{log[-3000:]}")
        lib = ctypes.CDLL(so)
        lib.decode_attention_fwd.argtypes = ([ctypes.c_void_p] * 7
                                             + [ctypes.c_int] * 7
                                             + [ctypes.c_void_p])
        lib.decode_attention_geometry.argtypes = ([ctypes.c_int] * 5
                                                  + [ctypes.c_void_p])
        libs[name] = {"lib": lib, "split_rows": lib.decode_attn_split_rows(),
                      "registers": [int(r) for r in re.findall(
                          r"Used (\d+) registers", log)],
                      "spill_stores": [int(r) for r in re.findall(
                          r"(\d+) bytes spill stores", log)]}
    return libs


def geometry(lib, shape, n_split: int) -> dict:
    """The split launch's dynamic shared bytes and blocks an SM."""
    B, L, H, K, hd = shape
    buf = (ctypes.c_int * 22)()
    err = lib.decode_attention_geometry(B, H, K, hd, n_split,
                                        ctypes.addressof(buf))
    if err != 0:
        raise SystemExit(f"chip_k8_tune: geometry entry returned {err}")
    return {"dyn_smem": buf[4], "blocks_per_sm": buf[10]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_k8_tune: no CUDA device", file=sys.stderr)
        return 2
    import chip_ab
    import chip_smoke as cs
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    print(cs.nvidia_smi_line(), flush=True)
    libs = build_all(os.path.join(REPO, "build", "k8_tune"))
    for name, v in libs.items():
        print(json.dumps({"variant": name, "consts": VARIANTS[name],
                          "split_rows": v["split_rows"],
                          "registers": v["registers"],
                          "spill_stores": v["spill_stores"]}), flush=True)
    for shape in chip_ab.K8_SHAPES:
        B, L, H, K, hd = shape
        q, k, v, lens, valid = chip_ab.decode_inputs(torch, shape)
        with torch.no_grad():
            want = decode_attention_ref(q, k, v, lens)
        out = torch.empty_like(q)
        scratch = {}

        def call(name):
            n_split = -(-L // libs[name]["split_rows"])
            if name not in scratch:
                scratch[name] = (
                    torch.empty((B, H, n_split, hd), device="cuda"),
                    torch.empty((B, H, n_split, 2), device="cuda"))
            o_part, ml_part = scratch[name]
            err = libs[name]["lib"].decode_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                o_part.data_ptr(), ml_part.data_ptr(), out.data_ptr(), B, L,
                H, K, hd, 0, n_split,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"chip_k8_tune: {name} at {shape} "
                                 f"returned {err}")

        rows = {}
        for name in libs:
            call(name)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            if not VARIANTS[name].get("loads_only"):
                ok, _ = cs.close(torch, out, want, cs.K8_ATOL, cs.K8_RTOL)
                if not ok:
                    raise SystemExit(f"chip_k8_tune: {name} at {shape} "
                                     f"disagrees (max abs err {err})")
            rows[name] = {"max_abs_err": err, **geometry(
                libs[name]["lib"], shape, -(-L // libs[name]["split_rows"]))}
        times = {name: [] for name in libs}
        for _ in range(ROUNDS):
            for name in libs:
                call(name)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CALLS):
                    call(name)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / CALLS)
        nvalid = int(valid.sum())
        b_ms, b_by = cs.bound_ms(
            nvalid * K * hd * 2 * 2 + 2 * B * H * hd * 2 + B * 4,
            4.0 * nvalid * H * hd)
        for name, t in times.items():
            ms = sorted(t)[ROUNDS // 2]
            rows[name].update(ms=ms, bound_share=b_ms / ms)
        print(json.dumps({"shape": list(shape), "valid_rows": nvalid,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "variants": rows}), flush=True)
        del q, k, v, want, scratch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
