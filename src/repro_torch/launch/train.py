"""Training launcher (the counterpart of ``repro/launch/train.py``: the
same flags plus ``--device``).

One rank on the card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt3_medium_moe \
        --steps 20 --seq-len 512 --global-batch 8 --microbatch 4 --remat

A 2x2 (pod x data) EP world of four ranks over gloo, at the reduced size on
the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt3_medium_moe \
        --reduced --device cpu --devices 4 --mesh-shape 2,2,1 --steps 10

``--mesh-shape`` lists the hierarchy axes outermost first with the
reference's trailing ``model`` axis (tensor parallelism:
``prod(hierarchy) * model`` processes); ``--topology`` takes a nested
spec of the hierarchy instead (model 1).  A data x model world on the
CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt3_medium_moe \
        --reduced --device cpu --mesh-shape 2,2 --steps 4 --seq-len 32

A model axis above 1 is refused, before any rank is spawned, where it
does not divide a width the port splits by (``model.tp_refusal``: MLA's
or the xLSTM heads, Mamba's inner dim, an expert width, and on the card a
model rank's expert width that is not a multiple of 64); ``--ckpt``
writes one payload a process.
``--production`` and ``--multi-pod`` name the reference's TPU meshes and
are refused.
"""

import argparse
import ast
import math
import sys


def _deep_tuple(spec):
    if isinstance(spec, int):
        return spec
    return tuple(_deep_tuple(s) for s in spec)


def _run(world, args, sizes, model=1):
    """Train on this rank (``world`` None: one rank) and print the summary
    on rank 0."""
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.training import trainer

    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    topo = _deep_tuple(ast.literal_eval(args.topology)) if args.topology \
        else ()
    run = RunConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                    learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(1, args.steps // 10),
                    aux_mode=args.aux_mode, aux_weight=args.aux_weight,
                    microbatch=args.microbatch, remat=args.remat,
                    seed=args.seed, topology=topo)
    rank = 0 if world is None else world.process_rank
    res = trainer.train(arch, run, world, steps=args.steps,
                        aux_mode=args.aux_mode, log_every=args.log_every,
                        ckpt_path=args.ckpt, verbose=rank == 0,
                        device=args.device)
    if rank == 0:
        print(f"done: {args.steps} steps on {math.prod(sizes) * model} "
              f"rank(s), "
              f"{res.steps_per_sec:.3f} steps/s, final loss "
              f"{res.losses[-1]:.4f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the EP world (one process each, joined "
                         "over gloo); 0 or 1: one rank")
    ap.add_argument("--mesh-shape", default="1,1",
                    help="data,model (or pod,data,model / "
                         "pod,node,data,model); model: tensor parallelism")
    ap.add_argument("--topology", default="",
                    help="nested topology spec (paper Fig. 2 notation), "
                         "e.g. '[[2,2],[2,2]]'; overrides --mesh-shape")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--aux-mode", default="ta",
                    choices=["ta", "lb", "hir", "none"])
    ap.add_argument("--aux-weight", type=float, default=1.0)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs the plain versions of "
                         "the kernels")
    args = ap.parse_args(argv)

    if args.production or args.multi_pod:
        ap.error("--production / --multi-pod name the reference's TPU "
                 "meshes; this port runs an EP world given by --devices "
                 "and --mesh-shape or --topology")
    from repro_torch.launch import mesh
    model = 1
    if args.topology:
        sizes = mesh.mesh_from_topology(ast.literal_eval(args.topology))
    else:
        dims = tuple(int(x) for x in args.mesh_shape.split(","))
        if len(dims) not in (2, 3, 4) or dims[-1] < 1:
            ap.error(f"--mesh-shape {args.mesh_shape}: 2 to 4 axes, the "
                     f"last the model axis")
        sizes, model = dims[:-1], dims[-1]
    if model > 1:
        from repro_torch.configs.base import get_config
        from repro_torch.models.model import tp_refusal
        arch = get_config(args.arch)
        why = tp_refusal(arch.reduced() if args.reduced else arch, model,
                         device=args.device)
        if why:
            ap.error(f"--mesh-shape {args.mesh_shape}: model axis {model}; "
                     f"{why}")
    n = math.prod(sizes) * model
    if args.devices not in (0, n):
        ap.error(f"the world {sizes} x model {model} has {n} ranks, "
                 f"--devices gives {args.devices}")
    if n == 1:
        _run(None, args, sizes)
        return 0
    mesh.spawn(_run, sizes, "gloo", args.device, args=(args, sizes, model),
               model=model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
