#!/usr/bin/env python3
"""How well does the first-step loss of ``chip_smoke.py``'s
``train_2x2_pipelined`` phase guard the int8 ragged grouped FFN (K7)?
Run from the repository root on one NVIDIA GPU:

    python3 chip_k7_guard.py [--layers N] [--ep-tp]

The phase's setting: full-width gpt3_medium_moe at the phase's depth
(``chip_smoke.WORLD_LAYERS`` of its 12 layers, or ``--layers``), a 2x2
(pod x data) EP world of four gloo ranks sharing the card,
``dispatch="a2a_pipelined"``, ``wire_codec="int8"``, the overlap model's
chunk count (8), seq 512, batch 8, weights and batch from seed 0; with
``--ep-tp``, ``train_ep_tp``'s (data 2, model 2) world instead.  Every
rank computes the world-mean loss of that first batch through the plain
path (kernels off) and through the kernel path, once sound and once
under each planted fault.  A fault multiplies the per-segment activation
scales that K7's wrapper hands the kernel (``ops.quantize_segments``) by
a factor: on the chunks' narrow (stage-1, 2-row) segments only, or on
every segment.  A factor of 0 zeroes those segments' output rows; where
every segment has one width (a plan of one stage) the narrow faults do
not apply and are reported as null.  The faults live in this process
only; the package is not changed.

Prints the ``nvidia-smi`` name and power limit, then one JSON object with
each run's loss and its relative gap to the plain path's.  Exits non-zero
without a card.
"""

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke  # noqa: E402  (after the path insert)

# (name, which segments, factor on their activation scales)
FAULTS = (("stage1_zeroed", "narrow", 0.0),
          ("stage1_scale_x2", "narrow", 2.0),
          ("stage1_scale_x1.25", "narrow", 1.25),
          ("all_scale_x1.1", "all", 1.1))


class NoNarrowSegments(Exception):
    """The call's segments all have one width."""


def planted_quantize(real, which: str, factor: float):
    """``ops.quantize_segments`` with the scales of the chosen segments
    multiplied by ``factor`` (narrow: the segments of the call's smallest
    width, when the widths differ)."""
    def quantize(x, offs):
        xq, sx = real(x, offs)
        widths = [offs[s + 1] - offs[s] for s in range(len(offs) - 1)]
        if which == "all":
            hit = [True] * len(widths)
        else:
            if len(set(widths)) < 2:
                raise NoNarrowSegments(widths)
            hit = [w == min(widths) for w in widths]
        f = [factor if h else 1.0 for h in hit]
        return xq, sx * sx.new_tensor(f)
    return quantize


def guard_rank(world, out_path: str, num_layers: int) -> None:
    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.kernels import backend
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import dataclasses
    arch = dataclasses.replace(get_config(chip_smoke.ARCH_ID),
                               num_layers=num_layers)
    batch_size = chip_smoke.TRAIN_BATCH_22
    run = RunConfig(seq_len=chip_smoke.TRAIN_SEQ, global_batch=batch_size,
                    warmup_steps=1, aux_mode="ta", dispatch="a2a_pipelined",
                    a2a_num_chunks=0, wire_codec="int8", seed=0)

    def ctx_for(use_pallas):
        return model_lib.build_ctx(arch, world, seq_len=run.seq_len,
                                   global_batch=batch_size,
                                   aux_mode=run.aux_mode,
                                   dispatch=run.dispatch,
                                   a2a_num_chunks=run.a2a_num_chunks,
                                   wire_codec=run.wire_codec,
                                   use_pallas=use_pallas, device="cuda")

    plain_ctx, kernel_ctx = ctx_for(False), ctx_for(None)
    params = model_lib.init_params(
        plain_ctx, torch.Generator(device="cuda").manual_seed(run.seed))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size,
                                  seq_len=run.seq_len,
                                  global_batch=batch_size, seed=run.seed))
    batch = shard_batch(data.batch(0), world, "cuda")

    def loss(ctx):
        with torch.no_grad():
            _, m = transformer.loss_fn(params, batch, ctx,
                                       aux_weight=run.aux_weight)
            return float(trainer.world_mean_metrics(m, world)["loss"])

    plain = loss(plain_ctx)
    backend.reset_launches()
    runs = {"sound": loss(kernel_ctx)}
    sound_launches = backend.LAUNCHES[ops.KERNEL_QUANT]
    real = ops.quantize_segments
    for name, which, factor in FAULTS:
        ops.quantize_segments = planted_quantize(real, which, factor)
        try:
            runs[name] = loss(kernel_ctx)
        except NoNarrowSegments:
            runs[name] = None
        finally:
            ops.quantize_segments = real
    if world.process_rank == 0:
        report = {
            "layers": num_layers,
            "a2a_num_chunks": kernel_ctx.a2a_num_chunks,
            "caps": list(kernel_ctx.plan.caps),
            "k7_launches_sound": sound_launches,
            "plain_loss": plain,
            "runs": {n: None if v is None else
                     {"loss": v, "rel_gap": abs(v - plain) / abs(plain)}
                     for n, v in runs.items()},
            "faults": [{"name": n, "segments": w, "factor": f}
                       for n, w, f in FAULTS]}
        with open(out_path, "w") as fh:
            json.dump(report, fh)


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=chip_smoke.WORLD_LAYERS,
                    help="depth of the model (default: the phase's)")
    ap.add_argument("--ep-tp", action="store_true",
                    help="train_ep_tp's (data 2, model 2) world")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k7_guard: no CUDA device; this measurement runs only on "
              "the card", file=sys.stderr)
        return 2
    from repro_torch.kernels import backend
    from repro_torch.launch import mesh

    print(chip_smoke.nvidia_smi_line(), flush=True)
    backend.build_all()
    out = os.path.join(tempfile.mkdtemp(prefix="chip_k7_guard_"),
                       "report.json")
    if args.ep_tp:
        sizes, model = chip_smoke.EP_TP_WORLD, chip_smoke.TP_MODEL
    else:
        sizes, model = chip_smoke.WORLD_22, 1
    mesh.spawn(guard_rank, sizes, "gloo", "cuda", args=(out, args.layers),
               model=model)
    with open(out) as fh:
        report = json.load(fh)
    report["world"] = list(sizes)
    report["model"] = model
    report["loss_rtol_int8"] = chip_smoke.LOSS_RTOL_INT8
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
