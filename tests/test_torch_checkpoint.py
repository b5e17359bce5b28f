"""The port's checkpoints (``repro_torch.checkpoint.ckpt``), case for case
with the ckpt units of ``tests/test_resilience.py``, plus what the port
adds: bf16 leaves round-trip bit for bit and a bf16/f32/int16 drift is
refused by name, the optimizer's int step, ``restore_into`` keeps the live
leaf tensors, one payload a rank (``rank_path``), and a checkpoint the
JAX package wrote (``repro.checkpoint.ckpt``, read back by it as numpy)
resuming in the port through ``convert.params_from_numpy`` /
``opt_state_from_numpy`` with the reference's next losses (float32,
rtol = atol = 1e-4, as ``test_torch_training.py``).
"""

import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_config as jax_get_config
from repro.training import trainer as jtrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig, get_config
from repro_torch.models import model
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.resilience import chaos as chaos_lib
from repro_torch.training import trainer

torch.set_num_threads(2)

ARCH_ID = "gpt3_medium_moe"


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones((4,), dtype=torch.int32)}


def test_ckpt_roundtrip_and_latest_step(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, _tree(), step=11)
    out = ckpt.restore(path, _tree())
    assert torch.equal(out["w"], _tree()["w"])
    assert out["b"].dtype == torch.int32
    assert ckpt.latest_step(path) == 11
    assert ckpt.verify(path)


def test_ckpt_restore_names_missing_and_extra_keys(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, {"w": _tree()["w"]})
    with pytest.raises(ValueError, match="missing key 'b'"):
        ckpt.restore(path, _tree())
    ckpt.save(path, _tree())
    with pytest.raises(ValueError, match="extra key 'b'"):
        ckpt.restore(path, {"w": _tree()["w"]})


def test_ckpt_restore_refuses_shape_and_dtype_drift(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, _tree())
    bad_shape = {"w": torch.zeros((3, 2)), "b": _tree()["b"]}
    with pytest.raises(ValueError, match="key 'w' has shape"):
        ckpt.restore(path, bad_shape)
    bad_dtype = {"w": _tree()["w"], "b": torch.ones((4,))}
    with pytest.raises(ValueError, match="refusing to cast"):
        ckpt.restore(path, bad_dtype)


def test_ckpt_manifest_catches_corruption(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, _tree())
    chaos_lib.corrupt_checkpoint(path, seed=0)
    assert not ckpt.verify(path)
    with pytest.raises(Exception):    # manifest ValueError or a broken zip
        ckpt.restore(path, _tree())


def test_ckpt_pre_manifest_checkpoints_still_restore(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, _tree())
    os.unlink(path + ".meta.json")    # no sidecar
    out = ckpt.restore(path, _tree())
    assert torch.equal(out["b"], _tree()["b"])
    assert not ckpt.verify(path)      # but verify() refuses to vouch for it


def test_bf16_roundtrip_and_dtype_drift_named(tmp_path):
    """numpy has no bfloat16: the payload keeps the int16 bits and the
    torch dtype, so the leaf comes back bit for bit, and a template of
    float32 or int16 (the stored bits' type) is refused by name."""
    path = str(tmp_path / "b.npz")
    g = torch.Generator().manual_seed(0)
    w = torch.randn((5, 7), generator=g).to(torch.bfloat16)
    w[0, 0] = float("nan")
    w[0, 1] = float("-inf")
    ckpt.save(path, {"w": w, "step": 3}, step=3)
    out = ckpt.restore(path, {"w": torch.zeros_like(w), "step": 0})
    assert out["w"].dtype == torch.bfloat16 and out["step"] == 3
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
    for dtype in (torch.float32, torch.int16):
        with pytest.raises(ValueError,
                           match="key 'w' has dtype bfloat16.*refusing"):
            ckpt.restore(path, {"w": torch.zeros((5, 7), dtype=dtype),
                                "step": 0})
    with pytest.raises(ValueError, match="key 'step' has dtype int"):
        ckpt.restore(path, {"w": w, "step": torch.zeros(())})


def test_restore_into_keeps_live_leaves(tmp_path):
    """A rollback copies into the live tensors: parameters stay the same
    leaf tensors with ``requires_grad``; the int step is replaced."""
    path = str(tmp_path / "s.npz")
    params = {"layers": [{"w": torch.randn(3, 4)}], "b": torch.randn(4)}
    state = {"params": params, "opt": adamw.init_state(params)}
    state["opt"]["step"] = 7
    ckpt.save(path, state, step=7)
    want = [t.clone() for t in adamw.tree_leaves(state["params"])]
    live_p = adamw.tree_map(lambda t: torch.zeros_like(t).requires_grad_(),
                            params)
    live = {"params": live_p, "opt": adamw.init_state(live_p)}
    ids = [id(t) for t in adamw.tree_leaves(live_p)]
    out = ckpt.restore_into(path, live)
    assert out["opt"]["step"] == 7
    got = adamw.tree_leaves(out["params"])
    assert [id(t) for t in got] == ids
    assert all(t.requires_grad and t.is_leaf for t in got)
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)


def test_rank_path():
    assert ckpt.rank_path("/x/ck.npz", 0, 1) == "/x/ck.npz"
    assert ckpt.rank_path("/x/ck-000003.npz", 2, 4) == "/x/ck-000003.rank2.npz"


def test_checkpoint_resume(tmp_path):
    """The port's mirror of ``test_system.py::test_checkpoint_resume``
    (which trains ``olmo_1b``; this one trains ``gpt3_medium_moe``): the
    final save restores bit for bit."""
    arch = get_config(ARCH_ID).reduced()
    run = RunConfig(seq_len=16, global_batch=2, total_steps=10,
                    warmup_steps=1, aux_mode="none")
    path = str(tmp_path / "m.npz")
    res = trainer.train(arch, run, steps=3, verbose=False, ckpt_path=path,
                        device="cpu")
    restored = ckpt.restore(path, {"params": res.params,
                                   "opt": res.opt_state})
    assert ckpt.latest_step(path) == 3
    assert restored["opt"]["step"] == res.opt_state["step"] == 3
    for a, b in zip(adamw.tree_leaves(res.params),
                    adamw.tree_leaves(restored["params"])):
        assert torch.equal(a.detach(), b)


def test_reference_checkpoint_resumes_in_port(mesh11, tmp_path):
    """The reference trains 2 steps and saves; its checkpoint, read back
    by the reference's ``restore``, becomes the port's params and AdamW
    state, and the port's next 2 steps give the reference's steps 2 and 3
    (the reference trains 4 steps from the same seed: its steps 2-3 start
    from exactly the saved state)."""
    kw = dict(seq_len=32, global_batch=4, warmup_steps=1, total_steps=10,
              aux_mode="ta", seed=0)
    jarch = jax_get_config(ARCH_ID).reduced()
    path = str(tmp_path / "ref.npz")
    first = jtrainer.train(jarch, JRunConfig(**kw), mesh11, steps=2,
                           log_every=1, verbose=False, ckpt_path=path)
    full = jtrainer.train(jarch, JRunConfig(**kw), mesh11, steps=4,
                          log_every=1, verbose=False)
    tree = jckpt.restore(path, {"params": first.params,
                                "opt": first.opt_state})
    tree = jax.tree_util.tree_map(np.asarray, tree)
    arch = get_config(ARCH_ID).reduced()
    ctx = model.build_ctx(arch, seq_len=32, global_batch=4, device="cpu")
    params = params_from_numpy(tree["params"], ctx, "cpu")
    opt = opt_state_from_numpy(tree["opt"], ctx, "cpu")
    assert opt["step"] == 2
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    step = trainer.make_train_step(ctx, RunConfig(**kw))
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=32,
                                  global_batch=4, seed=0))
    for i in (2, 3):
        params, opt, m = step(params, opt, data.batch(i))
        want = full.metrics_history[i]
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4,
                                       atol=1e-4)
