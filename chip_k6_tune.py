"""Reads K6 (the dense grouped FFN of ``csrc/moe_gemm.cu``) in other launch
geometries than the one the port runs, on one card.

    python3 chip_k6_tune.py

``moe_gemm.cu`` fixes K6's geometry in three constants, ``K6_STAGES``
(the ``cp.async`` ring depth), ``K6_ROWS`` (64: a block computes one
64-row tile; 128: an expert's two tiles over one weight stage) and
``K6_WM`` (the warps 1 x 4, each 16 columns of every row, or 2 x 2), and
in the grid's order (a tile's columns first).  For each combination in
``VARIANTS`` this script writes a copy of the source with those values
(and, where asked, every tile of a column first) plus a small entry that
reports the launches' shared bytes and resident blocks an SM, builds
them all at once (one nvcc each, into the gitignored ``build/k6_tune/``),
and prints one JSON line a build: ptxas's registers and spills, the
shared bytes and blocks an SM, and, on the einsum phase's input
(``chip_smoke.einsum_k6_case``: the [64, 128, 1024] bf16 capacity buffer
of full-width gpt3_medium_moe, layer 0's weights from seed 0), gelu and
swiglu each held against ``grouped_ffn_ref`` at ``chip_smoke.K6_ATOL,
K6_RTOL`` and read as ``device_ms`` (the profiler's kernel time a call,
``chip_ab.device_ms``) with each launch's share.  The default build's
ptxas lines of K3 and K4 (whose sources share ``csrc/moe_mma.cuh``) come
first.  Exits non-zero without a card, when the source no longer holds a
line it rewrites, or when a variant fails to build or disagrees.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

#: (K6_STAGES, K6_ROWS, K6_WM, columns first) of each build
VARIANTS = tuple((st, rows, wm, cols) for rows in (64, 128)
                 for wm in (1, 2) for cols in (1, 0) for st in (2, 3, 4))

#: the grid order of ``dense_block``: a tile's columns first, as the
#: source has it, and every tile of a column first
COLS_FIRST = "const int b = blockIdx.x / ncols, col = blockIdx.x % ncols;"
TILES_FIRST = ("const int tiles = gridDim.x / ncols;\n"
               "  const int b = blockIdx.x % tiles, col = blockIdx.x / tiles;")

#: appended to each copy: out[0 .. 5] = dynamic shared bytes and resident
#: blocks an SM of the gelu up, swiglu up and down launches
GEOMETRY = r"""
extern "C" int k6_geometry(int* out) {
  int up = 0, up_sw = 0, down = 0;
  cudaError_t err = smem_opt_in(dense_up_kernel<false>, K6_UP_SMEM,
                                dense_up_opt_in[0]);
  if (err == cudaSuccess)
    err = smem_opt_in(dense_up_kernel<true>, K6_UP_SMEM_SWIGLU,
                      dense_up_opt_in[1]);
  if (err == cudaSuccess)
    err = smem_opt_in(dense_down_kernel, K6_DOWN_SMEM, dense_down_opt_in);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &up, dense_up_kernel<false>, THREADS, K6_UP_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &up_sw, dense_up_kernel<true>, THREADS, K6_UP_SMEM_SWIGLU);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &down, dense_down_kernel, THREADS, K6_DOWN_SMEM);
  const int vals[6] = {K6_UP_SMEM, up, K6_UP_SMEM_SWIGLU, up_sw,
                       K6_DOWN_SMEM, down};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return (int)err;
}
"""


def variant_source(src: str, v) -> str:
    """``moe_gemm.cu`` with variant ``v``'s geometry and the geometry
    entry; raises when a line to rewrite is not there exactly once."""
    edits = [(f"constexpr int {name} = {default};",
              f"constexpr int {name} = {val};")
             for name, default, val in (("K6_STAGES", 2, v[0]),
                                        ("K6_ROWS", 128, v[1]),
                                        ("K6_WM", 2, v[2]))]
    if not v[3]:
        edits.append((COLS_FIRST, TILES_FIRST))
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"chip_k6_tune: moe_gemm.cu holds {old!r} "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src + GEOMETRY


def build(backend, variants):
    """nvcc of a copy of ``moe_gemm.cu`` for every variant at once;
    returns ``{variant: (library path, ptxas lines)}``."""
    out_dir = os.path.join(REPO, "build", "k6_tune")
    os.makedirs(out_dir, exist_ok=True)
    src = (backend.CSRC_DIR / "moe_gemm.cu").read_text()
    procs = {}
    for v in variants:
        stem = os.path.join(out_dir, "moe_gemm_s%d_r%d_w%d_c%d" % v)
        with open(stem + ".cu", "w") as fh:
            fh.write(variant_source(src, v))
        procs[v] = (stem + ".so", subprocess.Popen(
            [backend._nvcc(), *backend.NVCC_FLAGS,
             "-I" + str(backend.CSRC_DIR), "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for v, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_k6_tune: nvcc failed for {v}:\n{log}")
        built[v] = (lib, [ln.strip() for ln in log.splitlines()])
    return built


def ptxas_of(lines):
    """K6's kernels' ptxas lines: each entry's name, its spills and
    registers."""
    keep, on = [], False
    for ln in lines:
        if "Compiling entry" in ln:
            on = "dense_" in ln
            if on:
                keep.append(ln.split("'")[1] if "'" in ln else ln)
        elif on and ("registers" in ln or "spill" in ln):
            keep.append(ln)
    return keep


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_k6_tune: no CUDA device; this runs only on the card",
              file=sys.stderr)
        return 2
    import chip_ab
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.core.dispatch import base as moe_base
    from repro_torch.kernels import backend
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ref
    from repro_torch.models import model as model_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    built = build(backend, VARIANTS)
    backend.build_all(["moe_fused", "moe_gemm"])
    print(json.dumps({"default_ptxas": {
        n: [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]
        for n, log in backend.BUILD_LOGS.items()}}), flush=True)

    arch = get_config(cs.ARCH_ID)
    ctx = model_lib.build_ctx(arch, None, seq_len=cs.TRAIN_SEQ,
                              global_batch=cs.TRAIN_BATCH_1, aux_mode="lb",
                              dispatch="einsum", use_moe_kernel=True,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe_base.init_moe_params(ctx.moe_cfg, ctx.ep, ctx.gate_cfg, gen,
                                 "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        x, w_in, w_out, _ = cs.einsum_k6_case(
            torch, {"layers": [{"ffn": p}]}, arch, gen)
        w_gate = (torch.randn(w_in.shape, generator=gen, device="cuda")
                  * arch.d_model ** -0.5).to(torch.bfloat16)
        want = {act: grouped_ffn_ref(x, w_in, wg, w_out, activation=act)
                for act, wg in (("gelu", None), ("swiglu", w_gate))}
    E, C, d = x.shape
    f = w_in.shape[2]
    h = torch.empty((E, C, f), dtype=torch.bfloat16, device="cuda")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    V, I = ctypes.c_void_p, ctypes.c_int
    ok = True
    for v, (path, log) in built.items():
        lib = ctypes.CDLL(path)
        fn = lib.grouped_ffn_dense
        fn.argtypes = [V, I, I, I, I, V, V, V, V, V, I, V]
        fn.restype = I
        geo = (ctypes.c_int * 6)()
        lib.k6_geometry.argtypes = [V]
        err = lib.k6_geometry(ctypes.addressof(geo))
        row = {"K6_STAGES": v[0], "K6_ROWS": v[1], "K6_WM": v[2],
               "cols_first": v[3], "geometry_err": err,
               "smem_up": geo[0], "blocks_per_sm_up": geo[1],
               "smem_up_swiglu": geo[2], "blocks_per_sm_up_swiglu": geo[3],
               "smem_down": geo[4], "blocks_per_sm_down": geo[5],
               "ptxas": ptxas_of(log)}
        for act, wg in (("gelu", None), ("swiglu", w_gate)):
            def call(wg=wg):
                rc = fn(x.data_ptr(), E, C, d, f, w_in.data_ptr(),
                        0 if wg is None else wg.data_ptr(),
                        w_out.data_ptr(), h.data_ptr(), y.data_ptr(),
                        int(wg is not None), stream)
                if rc:
                    raise SystemExit(f"chip_k6_tune: {v} {act}: "
                                     f"cudaError {rc}")
            y.zero_()
            call()
            torch.cuda.synchronize()
            good, err_max = cs.close(torch, y, want[act], cs.K6_ATOL,
                                     cs.K6_RTOL)
            ok = ok and good
            dev, by_key = chip_ab.device_ms(torch, call)
            row[act] = {"ok": good, "max_abs_err": err_max,
                        "device_ms": dev,
                        "by_launch": chip_ab.ours_by_launch(
                            by_key, ("dense_up_kernel",
                                     "dense_down_kernel"))}
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
