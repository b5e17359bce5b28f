#!/usr/bin/env python3
"""The CPU companion of ``chip_smoke.py``'s serve_tp2_families verdict:
how far do the families' bf16 runs on the model axis drift from float32,
beside the one-rank bf16 runs?  On the CPU, at each config's reduced
widths:

    python3 chip_tp_drift.py [--families dsv2,jamba] [--depth N]
                             [--seeds 9] [--draws 1] [--by-layer]

For each family and seed, the config's ``reduced()`` widths in bf16 at
``chip_smoke.py``'s serve_tp2_families depth (or ``--depth``, its group
cut as ``chip_smoke.cut_depth`` cuts it), weights from the seed: one
rank's bf16 and float32 plain runs and a (data 1, model 2) gloo world's
bf16 plain run, each of ``--draws`` draws of the E2E rows
(``chip_smoke.tp_family_prompt``: one prefill, TP_FAMILY_STEPS decode
steps).  Prints one JSON line a family and seed with
``chip_smoke.row_drift``'s readings (the world's run in the place of the
kernel path) and the two whole runs' ratio.

With ``--by-layer`` (families without cross-attention or a frontend),
each sublayer instead takes the one-rank float32 run's input to it (a
prompt of TRAIN_TOKENS tokens a row, the training forward), rounded to
bf16, on one rank and on the world: one JSON line a family, seed and
sublayer with each one's relative error from the float32 sublayer's
output, and the number of tokens whose top-k experts differ from the
float32 run's (its MoE FFN's, where it has one).
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke  # noqa: E402  (after the path insert)

#: short name -> (config, serve_tp2_families' depth)
FAMILIES = {"dsv2": "deepseek_v2_lite_16b", "jamba": "jamba_v0_1_52b",
            "xlstm": "xlstm_350m", "whisper": "whisper_tiny",
            "vlm": "internvl2_26b"}
DEPTHS = dict(chip_smoke.TP_FAMILIES)
#: a reduced vision model's prompt: its patches, then this many tokens
VLM_TOKENS = 16
#: ``--by-layer``: the rows and tokens of its training-forward input
TRAIN_ROWS, TRAIN_TOKENS = 4, 32


def arch_of(name: str, depth: int, dtype: str = "bfloat16"):
    from repro_torch.configs.base import get_config
    aid = FAMILIES[name]
    arch = get_config(aid).reduced()
    return dataclasses.replace(
        chip_smoke.cut_depth(arch, depth or DEPTHS[aid]), dtype=dtype)


def ctx_of(arch, world=None):
    from repro_torch.models import model as model_lib
    ctx = model_lib.build_ctx(arch, world, device="cpu", use_flash=False,
                              aux_mode="none", seq_len=64,
                              global_batch=chip_smoke.E2E_ROWS)
    return dataclasses.replace(ctx, use_pallas=False)


def prompts(arch, draws: int):
    import numpy as np
    import torch
    length = (arch.frontend_len + VLM_TOKENS if arch.frontend == "vision"
              else chip_smoke.E2E_PROMPT)
    return [chip_smoke.tp_family_prompt(torch, np, arch, d, device="cpu",
                                        length=length)
            for d in range(draws)]


def logits(params, ctx, draws, world=None):
    """The draws' logits [steps + 1, draws * E2E_ROWS, V]."""
    import torch
    with torch.no_grad():
        return torch.cat([chip_smoke.e2e_logits(
            torch, params, ctx, prompt, world, frontend=fe,
            steps=chip_smoke.TP_FAMILY_STEPS) for prompt, fe in draws], 1)


def world_rank(world, names, depth, seeds, draws, out_dir) -> None:
    import torch

    from repro_torch.models import model as model_lib
    out = {}
    for name in names:
        arch = arch_of(name, depth)
        ctx = ctx_of(arch, world)
        for seed in seeds:
            params = model_lib.init_params(ctx,
                                           torch.Generator().manual_seed(seed))
            out[name, seed] = logits(params, ctx, prompts(arch, draws), world)
    if world.process_rank == 0:
        torch.save(out, os.path.join(out_dir, "world.pt"))


def layer_inputs(name: str, depth: int, seed: int) -> list:
    """The one-rank float32 run's residual stream before each sublayer
    and after the last (``--by-layer``)."""
    import numpy as np
    import torch

    from repro_torch.models import layers, model as model_lib, transformer
    arch = arch_of(name, depth)
    ctx = ctx_of(arch_of(name, depth, "float32"))
    params = chip_smoke._cast_params(model_lib.init_params(
        ctx_of(arch), torch.Generator().manual_seed(seed)), torch.float32)
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, arch.vocab_size,
                                       (TRAIN_ROWS, TRAIN_TOKENS)))
    with torch.no_grad():
        xs = [layers.embed_apply(params["embed"], tok, None)]
        for i, sub in enumerate(transformer.layer_list(arch)):
            xs.append(sublayer(params, xs[-1], sub, ctx, i)[0])
    return xs


def sublayer(params, x, sub, ctx, i):
    """Sublayer ``i`` on ``x``: (its output, the top-k picks of its MoE
    FFN's gate on its normed input, or None)."""
    import torch

    from repro_torch.core import gating
    from repro_torch.models import layers, transformer
    p = params["layers"][i]
    zero = torch.zeros(())
    y = transformer._apply_sublayer(p, x, sub, ctx, zero, zero, zero,
                                    layer_idx=i)[0]
    picks = None
    if sub.ffn == "moe":
        mid = transformer._apply_sublayer(
            p, x, dataclasses.replace(sub, ffn=None), ctx, zero, zero, zero,
            layer_idx=i)[0]
        h = layers.norm_apply(p["norm2"], mid, ctx.arch.norm)
        g = gating.gate_forward(p["ffn"]["gate"], h.reshape(-1, h.shape[-1]),
                                ctx.gate_cfg)
        picks = g["topk_idx"].sort(-1).values
    return y, picks


def layer_errors(params, ctx, xs) -> list:
    """Each sublayer's output on the float32 input rounded to bf16: (its
    relative error from the float32 output, its picks)."""
    import torch

    from repro_torch.models import transformer
    out = []
    with torch.no_grad():
        for i, sub in enumerate(transformer.layer_list(ctx.arch)):
            x = xs[i].to(torch.bfloat16)
            y, picks = sublayer(params, x, sub, ctx, i)
            want = xs[i + 1] - xs[i]
            out.append((float((y.float() - x.float() - want).norm()
                              / want.norm()), picks))
    return out


def world_layers(world, names, depth, seeds, out_dir) -> None:
    import torch

    from repro_torch.models import model as model_lib
    out = {}
    for name in names:
        ctx = ctx_of(arch_of(name, depth), world)
        for seed in seeds:
            params = model_lib.init_params(ctx,
                                           torch.Generator().manual_seed(seed))
            xs = torch.load(os.path.join(out_dir, f"{name}{seed}.pt"))
            out[name, seed] = layer_errors(params, ctx, xs)
    if world.process_rank == 0:
        torch.save(out, os.path.join(out_dir, "world.pt"))


def by_layer(names, depth: int = 0, seeds=(0,)) -> list:
    """``--by-layer``'s readings, a dict a family, seed and sublayer."""
    import torch

    from repro_torch.launch import mesh
    from repro_torch.models import model as model_lib, transformer
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        xs = {}
        for name in names:
            for seed in seeds:
                xs[name, seed] = layer_inputs(name, depth, seed)
                torch.save(xs[name, seed],
                           os.path.join(tmp, f"{name}{seed}.pt"))
        mesh.spawn(world_layers, chip_smoke.TP_WORLD, "gloo", "cpu",
                   args=(tuple(names), depth, tuple(seeds), tmp),
                   model=chip_smoke.TP_MODEL)
        world = torch.load(os.path.join(tmp, "world.pt"))
    for name in names:
        arch = arch_of(name, depth)
        f32_ctx = ctx_of(arch_of(name, depth, "float32"))
        for seed in seeds:
            params = model_lib.init_params(ctx_of(arch),
                                           torch.Generator().manual_seed(seed))
            f32 = chip_smoke._cast_params(params, torch.float32)
            one = layer_errors(params, ctx_of(arch), xs[name, seed])
            subs = transformer.layer_list(arch)
            for i, ((e1, p1), (ew, pw)) in enumerate(zip(one,
                                                         world[name, seed])):
                row = {"family": name, "seed": seed, "sublayer": i,
                       "mixer": subs[i].mixer, "ffn": subs[i].ffn,
                       "one_rank": e1, "world": ew, "ratio": ew / e1}
                if p1 is not None:
                    _, p32 = sublayer(f32, xs[name, seed][i], subs[i],
                                      f32_ctx, i)
                    row["flips_one_rank"] = int((p1 != p32).any(-1).sum())
                    row["flips_world"] = int((pw != p32).any(-1).sum())
                    row["tokens"] = int(p32.shape[0])
                rows.append(row)
    return rows


def drift(names, depth: int = 0, seeds=(0,), draws: int = 1) -> dict:
    """``{(name, seed): row_drift readings}`` of the world's bf16 run
    beside one rank's, both against one rank's float32 run."""
    import torch

    from repro_torch.launch import mesh
    from repro_torch.models import model as model_lib
    with tempfile.TemporaryDirectory() as tmp:
        mesh.spawn(world_rank, chip_smoke.TP_WORLD, "gloo", "cpu",
                   args=(tuple(names), depth, tuple(seeds), draws, tmp),
                   model=chip_smoke.TP_MODEL)
        world = torch.load(os.path.join(tmp, "world.pt"))
    out = {}
    for name in names:
        arch = arch_of(name, depth)
        f32_ctx = ctx_of(arch_of(name, depth, "float32"))
        for seed in seeds:
            params = model_lib.init_params(ctx_of(arch),
                                           torch.Generator().manual_seed(seed))
            batch = prompts(arch, draws)
            bf16 = logits(params, ctx_of(arch), batch)
            f32 = logits(chip_smoke._cast_params(params, torch.float32),
                         f32_ctx, batch)
            r = chip_smoke.row_drift(torch, world[name, seed], f32, bf16)
            r["ratio"] = (r["rel_err_kernel_vs_f32"]
                          / r["rel_err_plain_bf16_vs_f32"])
            out[name, seed] = r
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--depth", type=int, default=0,
                    help="layers (default: serve_tp2_families' depth)")
    ap.add_argument("--seeds", type=int, default=9)
    ap.add_argument("--draws", type=int, default=1)
    ap.add_argument("--by-layer", action="store_true",
                    help="each sublayer on the float32 run's input")
    args = ap.parse_args()
    names = args.families.split(",")
    if args.by_layer:
        for row in by_layer(names, args.depth, range(args.seeds)):
            print(json.dumps(row), flush=True)
        return 0
    res = drift(names, args.depth, range(args.seeds), args.draws)
    for (name, seed), r in res.items():
        print(json.dumps({"family": name, "seed": seed, **{
            k: v for k, v in r.items() if not k.startswith("rows")}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
