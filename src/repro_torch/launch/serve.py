"""Serving launcher: batched prefill + decode on one device (the
counterpart of ``repro/launch/serve.py``, same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt3_medium_moe \
        --batch 8 --prompt-len 64 --steps 32 --cache-len 128 --streams 8

``--devices`` and ``--mesh-shape`` accept only one device (``1`` and
``1,1``) in this slice.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--mesh-shape", default="1,1")
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
    if args.devices not in (0, 1) or any(d != 1 for d in dims):
        ap.error("this port runs on one device: --devices 1 and "
                 "--mesh-shape 1,1 only")

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import Request

    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    ctx = model_lib.build_ctx(arch, dims, seq_len=args.cache_len,
                              global_batch=args.batch, aux_mode="none",
                              device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model_lib.init_params(ctx, gen)
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
        report = engine.ServingEngine(params, ctx, cfg).run(reqs)
        print(f"served {len(report.streams)} streams at "
              f"{report.tokens_per_sec:.2f} tok/s aggregate "
              f"({report.decode_steps} decode steps, "
              f"{report.prefill_calls} prefill packs)")
        return 0
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(
        rng.integers(0, arch.vocab_size, size=(args.batch, args.prompt_len)),
        dtype=torch.int32, device=args.device)
    res = engine.generate(params, ctx, prompts, steps=args.steps,
                          cache_len=args.cache_len,
                          temperature=args.temperature)
    print(f"generated {tuple(res.tokens.shape)} tokens at "
          f"{res.steps_per_sec:.2f} decode steps/s")
    print("sample:", res.tokens[0][:16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
