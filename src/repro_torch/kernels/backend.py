"""Shared kernel backend policy, the nvcc build, and the launch counters.

Policy (the counterpart of ``repro/kernels/backend.py``):

* ``want_kernels(use_pallas, device)``: ``None`` (auto) means the CUDA
  kernels for CUDA tensors and the plain versions for CPU tensors;
  ``REPRO_TORCH_KERNELS`` (strictly parsed, like the reference's
  ``REPRO_KERNEL_INTERPRET``) overrides the auto default: ``1``/``true``
  turns the kernel branches on everywhere (on the CPU they then run their
  plain versions — the CPU lane's way to walk the fused control flow),
  ``0``/``false`` turns them off everywhere.  ``True``/``False`` force it.
* ``kernels_active(use_pallas, device)``: whether a wrapper launches its
  CUDA kernel — ``want_kernels`` and a CUDA device.  A CPU tensor always
  takes the plain version; a CUDA tensor with kernels wanted launches the
  kernel or raises (no fallback).

Build: every ``csrc/<name>.cu`` is compiled by ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``<repo>/build/kernels/<name>-<hash>.so`` (gitignored) at first use, and
loaded with ``ctypes``; the hash covers the source, the ``csrc/`` headers
it includes (``#include "..."``, recursively) and the flags.  Each source
exposes plain C entries that take ``void*`` pointers, ints and a
``cudaStream_t`` and return ``cudaGetLastError()``; :func:`check` raises
when that is not 0.
:func:`build_all` starts one nvcc per source at once.

Launch counters: :data:`LAUNCHES` holds one plain integer per kernel;
a wrapper adds one where it launches its kernel and nowhere else.

Kernel registry (read by ``repro_torch.analysis.launch_check``, the
counterpart of the reference's ``KERNEL_REGISTRY``): each
``kernels/<name>/ops.py`` registers a builder that states its CUDA
launches at the shapes its paths run as :class:`KernelLayout`\\ s, built
by the same Python functions its wrapper calls (the tile and segment
tables) and the same grid arithmetic as the host entry in ``csrc/``,
whose geometry entry the card's check compares with it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
from collections.abc import Callable, Sequence

import torch

_ENV_TRUE = ("1", "true")
_ENV_FALSE = ("0", "false")
ENV_VAR = "REPRO_TORCH_KERNELS"

CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"moe_permute.permute": 0,
                            "moe_permute.unpermute": 0,
                            "moe_gemm.grouped_ffn_ragged": 0,
                            "moe_gemm.grouped_ffn_ragged_quant": 0,
                            "moe_gemm.grouped_ffn": 0,
                            "moe_fused.local_moe": 0,
                            "flash_attn.flash_attention": 0,
                            "decode_attn.decode_attention": 0}


def env_kernels() -> bool | None:
    """Strictly-parsed ``REPRO_TORCH_KERNELS``: 1/true -> True, 0/false ->
    False, unset -> None (device decides); anything else raises."""
    raw = os.environ.get(ENV_VAR)
    if raw is None:
        return None
    val = raw.strip().lower()
    if val in _ENV_TRUE:
        return True
    if val in _ENV_FALSE:
        return False
    raise ValueError(f"{ENV_VAR}={raw!r} is not a recognized value; "
                     f"use one of {_ENV_TRUE + _ENV_FALSE}")


def _device_type(device) -> str:
    return torch.device(device).type


def want_kernels(use_pallas=None, device="cuda") -> bool:
    """The kernel branches' switch (engine-level: fused vs unfused)."""
    if use_pallas is not None:
        return bool(use_pallas)
    env = env_kernels()
    if env is not None:
        return env
    return _device_type(device) == "cuda"


def kernels_active(use_pallas=None, device="cuda") -> bool:
    """Whether a wrapper launches its CUDA kernel for tensors on
    ``device``: never for the CPU.  Called on every kernel launch, so it
    reads the device type and the environment once each."""
    dev_type = (device.type if isinstance(device, torch.device)
                else _device_type(device))
    if dev_type != "cuda":
        return False
    if use_pallas is not None:
        return bool(use_pallas)
    env = env_kernels()
    return True if env is None else env


def record_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_no_grad(name: str, *tensors) -> None:
    """Refuse a call that would need a backward the kernel does not have
    (the attention kernels are forward-only)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet; run under "
            f"torch.no_grad() or use the plain version")


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


# ---------------------------------------------------------------------------
# nvcc build + ctypes load
# ---------------------------------------------------------------------------

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: nvcc's stdout/stderr (ptxas register/spill report) per built source
BUILD_LOGS: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with
    ``#include "..."``, recursively, each once, in the order met."""
    seen, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in _sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its hashed library exists.
    Returns ``(final_path, tmp_path, Popen | None)``."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish_build(name: str, out, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=None) -> dict[str, pathlib.Path]:
    """Compile every (or the named) CUDA source at once — one nvcc process
    per source, all started before any is awaited — and load them."""
    names = list(names or sources())
    with _LOCK:
        started = {n: _start_build(n) for n in names if n not in _LIBS}
        try:
            for n, job in started.items():
                _finish_build(n, *job)
        finally:
            for _, tmp, proc in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp is not None and os.path.exists(tmp):
                    os.unlink(tmp)
        for n, (out, _, _) in started.items():
            _LIBS[n] = ctypes.CDLL(str(out))
    return {n: _lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """``fn`` of ``csrc/<name>.cu`` with its argtypes declared; every entry
    returns an int (its ``cudaGetLastError()``)."""
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def ptr(t: torch.Tensor | None) -> int:
    """A tensor's address for an entry argument declared ``c_void_p``
    (ctypes takes a plain int there)."""
    return 0 if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` (a CUDA tensor's device, so
    its index is set) as a plain int."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# kernel registry (read by repro_torch.analysis.launch_check)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    """Rows of one array that the blocks of a launch address: block ``i``
    (in the order of the grid dimension the span follows) reads or
    writes rows ``first[i] : first[i] + rows[i]`` of an array of
    ``extent`` rows, the rows its guards let through."""

    array: str
    extent: int
    first: tuple
    rows: tuple


@dataclasses.dataclass(frozen=True)
class Write:
    """An output of a launch: ``region(x, y, z)`` names the part of
    ``array`` that block (x, y, z) writes; blocks that name the same part
    write the same elements."""

    array: str
    region: Callable


@dataclasses.dataclass(frozen=True)
class LaunchDecl:
    """One CUDA launch as the host entry makes it: the ``__global__``
    function (its instantiation, as the geometry entry of its source
    names it), the grid (x, y, z), the threads a block, the dynamic and
    static shared memory of a block in bytes, the kernel's
    ``__launch_bounds__``, the rows its blocks address and what they
    write."""

    kernel: str
    grid: tuple
    threads: int
    dyn_smem: int
    static_smem: int
    launch_bounds: int
    spans: tuple = ()
    writes: tuple = ()


@dataclasses.dataclass(frozen=True)
class KernelLayout:
    """The launches of one call of a kernel's entry at one shape.

    ``meta``: ``seg_offsets`` / ``seg_experts`` (the segment table of a
    ragged layout), ``tiles`` and ``tile_kind`` (``"segment"``: K4's
    :func:`moe_fused.ops.plan_tiles` rows; ``"expert_span"``: K3's and
    K7's :func:`moe_fused.ops.plan_expert_tiles` rows), ``acc_guarded``
    (the ``(launch, array)`` pairs a launch accumulates into with
    atomics) and ``geometry`` (the arguments of the source's geometry
    entry that give these launches)."""

    kernel: str
    launches: tuple
    meta: dict = dataclasses.field(default_factory=dict)


KERNEL_REGISTRY: dict[str, Callable[[], Sequence[KernelLayout]]] = {}


def register_kernel(name: str):
    """Register a layout builder under ``name`` (a :data:`LAUNCHES` key).
    Builders take no arguments and return the kernel's layouts at the
    shapes its paths run."""

    def deco(fn):
        KERNEL_REGISTRY[name] = fn
        return fn

    return deco


def registered_layouts() -> dict[str, Sequence[KernelLayout]]:
    """Every registered builder's layouts, by kernel name; importing the
    kernel packages (which registers them) is the caller's job."""
    return {name: tuple(build()) for name, build in
            sorted(KERNEL_REGISTRY.items())}


def static_smem(nbytes: int) -> int:
    """A block's static shared memory as ptxas lays it out: the kernel's
    ``__shared__`` arrays (those it reads) in 128-byte units, as ``-Xptxas
    -v`` and ``cudaFuncGetAttributes`` report it on an H100."""
    return -(-nbytes // 128) * 128


def blocks(n: int, rows: int, extent: int) -> tuple:
    """``(first, rows)`` of ``n`` blocks of ``rows`` rows over an array of
    ``extent`` rows, the last one cut by the kernel's row guard."""
    first = tuple(i * rows for i in range(n))
    return first, tuple(max(0, min(rows, extent - f)) for f in first)
