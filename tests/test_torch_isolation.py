"""The port stands alone: no file of ``src/repro_torch`` (nor the
``chip_*.py`` scripts) imports ``jax`` or the JAX package ``repro``; every
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
    return sorted(PORT.rglob("*.py")) + sorted(REPO.glob("chip_*.py"))


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
    """The flash-attention kernel (K5) is forward-only and refuses a call
    that needs a gradient; K1-K4 give one: each ``autograd.Function``
    (driven here with its plain forward) backpropagates like autograd of
    its plain version."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.moe_fused import ops as f_ops
    from repro_torch.kernels.moe_fused.ref import local_moe_ref
    from repro_torch.kernels.moe_gemm import ops as g_ops
    from repro_torch.kernels.moe_gemm.ref import grouped_ffn_ragged_ref
    from repro_torch.kernels.moe_permute import ops as p_ops
    from repro_torch.kernels.moe_permute.ref import (permute_ref,
                                                     unpermute_ref)
    q = torch.randn(1, 4, 2, 32, requires_grad=True)
    with pytest.raises(NotImplementedError):
        backend.check_no_grad(fa_ops.KERNEL, q)
    with torch.no_grad():
        backend.check_no_grad(fa_ops.KERNEL, q)

    gen = torch.Generator().manual_seed(0)
    T, S, E, d, f = 6, 10, 2, 8, 16
    tok = torch.randint(0, T + 1, (S,), generator=gen, dtype=torch.int32)
    inv_idx = torch.randint(0, S + 1, (T, 2), generator=gen,
                            dtype=torch.int32)
    offs, exps = (0, 4, 10), (0, 1)
    valid = torch.tensor([3, 6], dtype=torch.int32)
    x, y, inv_w, w_s, wi, wo = (
        torch.randn(s, generator=gen) for s in
        ((T, d), (S, d), (T, 2), (S,), (E, d, f), (E, f, d)))
    cases = {
        "K1": (lambda a: p_ops.Permute.apply(a, tok, permute_ref),
               lambda a: permute_ref(a, tok), (x,)),
        "K2": (lambda a, w: p_ops.Unpermute.apply(a, inv_idx, w,
                                                  unpermute_ref),
               lambda a, w: unpermute_ref(a, inv_idx, w), (y, inv_w)),
        "K3": (lambda a, i, o: g_ops.GroupedFFNRagged.apply(
                   a, valid, i, None, o, (offs, exps, "gelu"),
                   lambda st, *t: grouped_ffn_ragged_ref(
                       t[0], st[0], st[1], t[1], t[2], t[3], t[4],
                       activation=st[2])),
               lambda a, i, o: grouped_ffn_ragged_ref(
                   a, offs, exps, valid, i, None, o, activation="gelu"),
               (y, wi, wo)),
        "K4": (lambda a, w, i, o: f_ops.LocalMoE.apply(
                   a, tok, w, valid, i, None, o, (offs, exps, "gelu"),
                   lambda st, *t: local_moe_ref(
                       t[0], t[1], t[2], st[0], st[1], t[3], t[4], t[5],
                       t[6], activation=st[2])),
               lambda a, w, i, o: local_moe_ref(
                   a, tok, w, offs, exps, valid, i, None, o,
                   activation="gelu"),
               (x, w_s, wi, wo)),
    }
    for name, (fn, plain, inputs) in cases.items():
        got, want = ([t.clone().requires_grad_(True) for t in inputs]
                     for _ in range(2))
        fn(*got).sum().backward()
        plain(*want).sum().backward()
        for a, b in zip(got, want):
            assert a.grad is not None, name
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6,
                                       msg=name)
