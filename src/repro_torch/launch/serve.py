"""Serving launcher: batched prefill + decode (the counterpart of
``repro/launch/serve.py``, same flags plus ``--device``).

One rank on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt3_medium_moe \
        --batch 8 --prompt-len 64 --steps 32 --cache-len 128 --streams 8

An expert-parallel world of four ranks over gloo (sharing the card, or
on the CPU with ``--device cpu``), the batch sharded over the ranks and
every MoE layer through the gather path:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt3_medium_moe \
        --reduced --device cpu --devices 4 --mesh-shape 4,1 --streams 4

``--mesh-shape`` is the reference's ``data,model``: ``data`` EP ranks,
each the ``model`` ranks of a tensor-parallel axis (attention by heads,
the FFNs by width, the embedding by vocabulary), ``data * model``
processes in all, and ``--devices`` (0: that product) must name that
many.  A tensor-parallel world on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt3_medium_moe \
        --reduced --device cpu --mesh-shape 2,2 --streams 4

Every family runs on a model axis (MLA and the xLSTM mixers by heads,
Mamba by inner channels, Whisper's encoder and cross-attention and
InternVL2's projector too).  A model axis above 1 is refused, before any
rank is spawned, where it does not divide a width the port splits by
(``model.tp_refusal``, by the leaves' names).
"""

import argparse
import sys


def _run(world, args):
    """Serve on this rank (``world`` None: one rank); rank 0 prints."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import Request

    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    device = args.device if world is None else world.device
    ctx = model_lib.build_ctx(arch, world, seq_len=args.cache_len,
                              global_batch=args.batch, aux_mode="none",
                              device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model_lib.init_params(ctx, gen)
    report = world is None or world.process_rank == 0
    if args.streams:
        rng = np.random.default_rng(1)
        reqs = [Request(uid=i,
                        tokens=rng.integers(0, arch.vocab_size,
                                            size=args.prompt_len).tolist(),
                        max_new_tokens=args.steps,
                        temperature=args.temperature)
                for i in range(args.streams)]
        cfg = engine.ServeConfig(num_slots=args.batch,
                                 cache_len=args.cache_len,
                                 prefill_pack=min(args.batch, 4),
                                 prompt_buckets=(args.prompt_len,))
        rep = engine.ServingEngine(params, ctx, cfg).run(reqs)
        if report:
            print(f"served {len(rep.streams)} streams at "
                  f"{rep.tokens_per_sec:.2f} tok/s aggregate "
                  f"({rep.decode_steps} decode steps, "
                  f"{rep.prefill_calls} prefill packs)", flush=True)
        return
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(
        rng.integers(0, arch.vocab_size, size=(args.batch, args.prompt_len)),
        dtype=torch.int32, device=device)
    res = engine.generate(params, ctx, prompts, steps=args.steps,
                          cache_len=args.cache_len,
                          temperature=args.temperature)
    if report:
        print(f"generated {tuple(res.tokens.shape)} tokens at "
              f"{res.steps_per_sec:.2f} decode steps/s")
        print("sample:", res.tokens[0][:16].tolist(), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the world (one process each, joined "
                         "over gloo); 0: the data axis of --mesh-shape")
    ap.add_argument("--mesh-shape", default="1,1",
                    help="data,model (the model axis: tensor "
                         "parallelism)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--streams", type=int, default=0,
                    help="serve this many queued requests through the "
                         "continuous-batching engine instead of one "
                         "fixed-batch generate call")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs the plain versions of "
                         "the kernels")
    args = ap.parse_args(argv)

    dims = tuple(int(x) for x in args.mesh_shape.split(","))
    if len(dims) != 2:
        ap.error(f"--mesh-shape {args.mesh_shape}: two axes, data,model")
    data, model = dims
    if model > 1:
        from repro_torch.configs.base import get_config
        from repro_torch.models.model import tp_refusal
        arch = get_config(args.arch)
        why = tp_refusal(arch.reduced() if args.reduced else arch, model,
                         device=args.device)
        if why:
            ap.error(f"--mesh-shape {args.mesh_shape}: model axis {model}; "
                     f"{why}")
    if args.devices not in (0, data * model):
        ap.error(f"--mesh-shape {args.mesh_shape} has {data * model} "
                 f"ranks, --devices gives {args.devices}")
    if data * model == 1:
        _run(None, args)
        return 0
    from repro_torch.launch import mesh
    mesh.spawn(_run, (data,), "gloo", args.device, args=(args,), model=model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
