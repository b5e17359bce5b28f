#!/usr/bin/env python3
"""The families' one-rank training on the card, beside the smoke's
verdicts: why ``chip_smoke.py`` holds Whisper, xLSTM and InternVL2 as it
does (``FAMILY_TRAIN``).  Run from the repository root on a machine with
one NVIDIA GPU:

    python3 chip_family_train.py [--steps 5] [--warmups 1 100]

For each of the smoke's ``FAMILY_TRAIN`` configurations (full width,
its cut depth and sequence, TRAIN_BATCH_1 rows, ``SyntheticLM``'s batch
0 with its frames or patches) and each warmup, ``--steps`` AdamW steps on that
one repeated batch from seed 0's weights, in bf16 and in float32 (the
same weights cast): each step's loss and gradient norm, one JSON line a
run.  Then xLSTM's first-step gradients in bf16 against float32, leaf by
leaf (each leaf's norm in both and the relative norm of the
difference), the largest leaves first.  Prints the card's name and power
limit first and last.

    python3 chip_family_train.py --faults

reads instead the faults the smoke's verdicts must see, each planted in
the bf16 run only, beside the sound bf16 run: the first step's loss and
global gradient norm against the float32 step's (relative), for each
``FAULTS`` entry that applies to the family (``grad_dropped``: the middle
decoder layer's gradients zeroed; ``mixer_skipped``: that layer's mixer
output projection zeroed; ``frontend_dropped``: the frames or patches
zeroed; ``patch_mask_ignored``: InternVL2's loss mask one over the
patches), and the losses of FAMILY_TRAIN_STEPS steps at the smoke's
warmup with the learning rate negated (``ascent``), which the smoke's
falling-loss check must refuse.
"""

import argparse
import dataclasses
import gc
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)


def setup(aid: str, layers: int, seq: int, warmup: int):
    """(context, bf16 weights from seed 0, the batch, the run) of one
    family at the smoke's training shapes."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.models import model as model_lib
    arch = get_config(aid)
    if layers:
        arch = cs.cut_depth(arch, layers)
    run = RunConfig(seq_len=seq, global_batch=cs.TRAIN_BATCH_1,
                    warmup_steps=warmup, aux_mode="none", seed=0)
    ctx = model_lib.build_ctx(arch, None, seq_len=seq,
                              global_batch=cs.TRAIN_BATCH_1,
                              aux_mode="none", device="cuda")
    params = model_lib.init_params(
        ctx, torch.Generator(device="cuda").manual_seed(0))
    batch = shard_batch(SyntheticLM(DataConfig(
        vocab_size=arch.vocab_size, seq_len=seq,
        global_batch=cs.TRAIN_BATCH_1, seed=0), arch).batch(0), None,
        "cuda")
    return ctx, params, batch, run


def in_dtype(ctx, params, dtype: str):
    import torch

    import chip_smoke as cs
    if dtype == "bfloat16":
        return ctx, params
    return (dataclasses.replace(ctx, arch=dataclasses.replace(
        ctx.arch, dtype=dtype)), cs._cast_params(params, torch.float32))


def steps_on_one_batch(aid, layers, seq, warmup, dtype, steps) -> dict:
    import torch
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    ctx, params, batch, run = setup(aid, layers, seq, warmup)
    ctx, params = in_dtype(ctx, params, dtype)
    for p in adamw.tree_leaves(params):
        p.requires_grad_(True)
    opt = adamw.init_state(params)
    step = trainer.make_train_step(ctx, run)
    losses, norms = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": aid, "layers": layers, "seq_len": seq, "warmup": warmup,
            "dtype": dtype, "losses": losses, "grad_norms": norms}


def leaf_gaps(aid, layers, seq, top: int = 25) -> dict:
    """The first step's gradients in bf16 against float32, leaf by leaf:
    ``[norm bf16, norm float32, |bf16 - float32| / |float32|, leaf]``."""
    import torch

    import chip_smoke as cs
    from repro_torch import sharding
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    ctx, params, batch, run = setup(aid, layers, seq, 1)
    grads, loss = {}, {}
    for dtype in ("bfloat16", "float32"):
        c, p = in_dtype(ctx, cs._clone_tree(params), dtype)
        for t in adamw.tree_leaves(p):
            t.requires_grad_(True)
        _, m = trainer._backward(p, batch, c, run)
        grads[dtype] = {"/".join(k): t.grad.float()
                        for k, t in sharding._leaves_with_paths(p)}
        loss[dtype] = float(m["loss"].detach())
        del p
    rows = []
    for k, gb in grads["bfloat16"].items():
        gf = grads["float32"][k]
        rows.append([float(gb.norm()), float(gf.norm()),
                     float((gb - gf).norm()) / max(float(gf.norm()), 1e-30),
                     k])
    rows.sort(key=lambda r: -max(r[0], r[1]))
    return {"arch": aid, "layers": layers, "seq_len": seq, "loss": loss,
            "leaves_by_norm": rows[:top]}


#: fault -> the families it applies to (None: every family)
FAULTS = {"grad_dropped": None, "mixer_skipped": None,
          "frontend_dropped": ("audio", "vision"),
          "patch_mask_ignored": ("vision",)}
#: the mixer output projections ``mixer_skipped`` zeroes: attention's,
#: the mLSTM's and the sLSTM's
MIXER_OUT = ("wo", "w_down", "w_out")


def first_step(ctx, params, batch, run, zero_grads=()) -> dict:
    """The first step's loss and global gradient norm, as the step logs
    them, with the gradients of the leaves at ``zero_grads`` (paths)
    zeroed before the norm."""
    import torch

    from repro_torch import sharding
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    for t in adamw.tree_leaves(params):
        t.requires_grad_(True)
    _, m = trainer._backward(params, batch, ctx, run)
    grads = [torch.zeros_like(t) if t.grad is None
             or "/".join(k) in zero_grads else t.grad
             for k, t in sharding._leaves_with_paths(params)]
    _, gn = trainer.sync_grads(params, ctx, grads)
    return {"loss": float(m["loss"].detach()), "grad_norm": float(gn)}


def fault_readings(aid, layers, seq) -> list:
    """The sound bf16 first step and each applicable fault's against the
    float32 step (gaps relative), then the ``ascent`` steps."""
    import torch

    import chip_smoke as cs
    from repro_torch import sharding
    from repro_torch.optim import adamw
    from repro_torch.training import trainer
    from repro_torch.configs.base import RunConfig
    ctx, params, batch, run = setup(aid, layers, seq,
                                    RunConfig().warmup_steps)
    c32, p32 = in_dtype(ctx, cs._clone_tree(params), "float32")
    f32 = first_step(c32, p32, batch, run)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    mid = f"layers/{ctx.arch.num_layers // 2}/"
    paths = ["/".join(k) for k, _ in sharding._leaves_with_paths(params)]
    rows = []
    for fault in ["sound"] + [f for f, kinds in FAULTS.items()
                              if kinds is None or ctx.arch.frontend in kinds]:
        p, b, zero = cs._clone_tree(params), dict(batch), ()
        if fault == "grad_dropped":
            zero = tuple(k for k in paths if k.startswith(mid))
        elif fault == "mixer_skipped":
            for k, t in sharding._leaves_with_paths(p):
                if "/".join(k[:-1]) == mid + "mixer" and k[-1] in MIXER_OUT:
                    t.data.zero_()
        elif fault == "frontend_dropped":
            b["frontend"] = torch.zeros_like(b["frontend"])
        elif fault == "patch_mask_ignored":
            b["loss_mask"] = torch.ones_like(b["loss_mask"])
        got = first_step(ctx, p, b, run, zero)
        rows.append({"arch": aid, "fault": fault, **got,
                     **{f"gap_{k}": abs(got[k] - f32[k]) / abs(f32[k])
                        for k in got}, "f32": f32})
        del p
        gc.collect()
        torch.cuda.empty_cache()
    run = dataclasses.replace(run, learning_rate=-run.learning_rate)
    for t in adamw.tree_leaves(params):
        t.requires_grad_(True)
    opt = adamw.init_state(params)
    step = trainer.make_train_step(ctx, run)
    losses = []
    for _ in range(cs.FAMILY_TRAIN_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    rows.append({"arch": aid, "fault": "ascent", "losses": losses,
                 "falls": losses[-1] < losses[0]})
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_family_train: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmups", type=int, nargs="+", default=[1, 100])
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    shapes = {aid: (layers, seq)
              for _, aid, layers, seq, _, _ in cs.FAMILY_TRAIN}
    if args.faults:
        for aid, (layers, seq) in shapes.items():
            for row in fault_readings(aid, layers, seq):
                print(json.dumps(row), flush=True)
        print(smi, flush=True)
        return 0
    for aid, (layers, seq) in shapes.items():
        for warmup in args.warmups:
            for dtype in ("bfloat16", "float32"):
                print(json.dumps(steps_on_one_batch(
                    aid, layers, seq, warmup, dtype, args.steps)), flush=True)
    print(json.dumps({"leaf_gaps": leaf_gaps(cs.XLSTM_ID,
                                             *shapes[cs.XLSTM_ID])}),
          flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
