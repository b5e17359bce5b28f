"""The port stands alone: no file of ``src/repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``; every
port module imports with ``jax`` blocked; ``chip_smoke.py`` fails without
a card instead of falling back to the CPU; and the kernel policy sends
CPU tensors to the plain versions.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import backend

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_repro():
    files = port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(REPO)): sorted(imported_roots(p) & set(FORBIDDEN))
           for p in files if imported_roots(p) & set(FORBIDDEN)}
    assert not bad, bad


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_every_port_module_imports_without_jax():
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\nsys.modules['jaxlib'] = None\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            f"print('imported', {len(mods)})\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_policy_resolution(monkeypatch):
    monkeypatch.delenv(backend.ENV_VAR, raising=False)
    assert backend.want_kernels(None, "cuda")
    assert not backend.want_kernels(None, "cpu")
    assert backend.want_kernels(True, "cpu")
    assert not backend.want_kernels(False, "cuda")
    # a CPU tensor never launches a CUDA kernel, whatever the flag says
    assert not backend.kernels_active(True, "cpu")
    assert backend.kernels_active(None, "cuda")
    assert not backend.kernels_active(False, "cuda")
    monkeypatch.setenv(backend.ENV_VAR, "1")
    assert backend.want_kernels(None, "cpu")
    assert not backend.kernels_active(None, "cpu")
    monkeypatch.setenv(backend.ENV_VAR, " FALSE ")
    assert not backend.want_kernels(None, "cuda")
    assert backend.want_kernels(True, "cuda")
    monkeypatch.setenv(backend.ENV_VAR, "yes")
    with pytest.raises(ValueError, match=backend.ENV_VAR):
        backend.want_kernels(None, "cpu")


def test_cpu_serve_never_counts_a_launch():
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import Request
    torch.set_num_threads(2)
    ctx = model.build_ctx(get_config("gpt3_medium_moe").reduced(),
                          use_flash=True, use_pallas=True, device="cpu")
    params = model.init_params(ctx, torch.Generator().manual_seed(0))
    backend.reset_launches()
    rep = engine.ServingEngine(params, ctx, engine.ServeConfig(
        num_slots=2, cache_len=16, prefill_pack=2, prompt_buckets=(8,))).run(
        [Request(uid=i, tokens=[1, 2, 3], max_new_tokens=3)
         for i in range(2)])
    assert rep.total_new_tokens == 6
    assert backend.LAUNCHES == {k: 0 for k in backend.LAUNCHES}


def test_kernel_wrappers_refuse_grad():
    from repro_torch.kernels.flash_attn import ops as fa_ops
    q = torch.randn(1, 4, 2, 32, requires_grad=True)
    with pytest.raises(NotImplementedError):
        backend.check_no_grad(fa_ops.KERNEL, q)
    with torch.no_grad():
        backend.check_no_grad(fa_ops.KERNEL, q)
