"""Multi-rank dry-run on the meta device (the counterpart of
``repro/launch/dryrun.py``): for every (arch x input shape x production
hierarchy), run rank 0's step once on ``meta`` tensors in one process —
no storage is allocated, no kernel runs — and print its memory, cost and
roofline terms on an H100.

The reference lowers and compiles against a fake 256- or 512-chip mesh.
Here rank 0 of the hierarchy is emulated by a recording EP world
(``launch.mesh.RecordingWorld``): the engine's collectives return tensors
of the right shape and are logged, so their wire bytes are counted. The
production hierarchies are the reference's meshes (pod1: ``data`` 16;
pod2: ``pod`` 2 x ``data`` 16; pod3: ``pod`` 2 x ``node`` 2 x ``data``
8), each with its 16-wide ``model`` axis: a rank holds its slices of the
weights (``model.shard_params``) and the step's model-axis collectives
are logged too.  Every family runs on the model axis; one whose split
widths the axis does not divide (``model.tp_refusal``: xLSTM-350M's 4
heads at 16) runs on the widest model axis that halving the production
one leaves and its widths divide, and its record says so
(``tensor_parallel`` and the note).  A batch smaller than the hierarchy
(``long_500k``) is whole on every rank with its cache.

The step is the one a user runs: ``trainer.make_train_step`` (forward,
backward, the gradient sync and AdamW) for ``train``,
``serving.engine.make_prefill`` for ``prefill`` and
``make_decode_step`` for ``decode``, with the kernels off (no kernel runs
on meta).  ``launch.analysis.CostMode`` counts FLOPs and HBM bytes of
every ATen op; ``arg_bytes`` is the parameters, gradients and AdamW's
two f32 moments for ``train`` (inputs and cache otherwise), and
``saved_bytes`` the tensors autograd keeps for the backward
(``torch.autograd.graph.saved_tensors_hooks``); ``fits`` compares their
sum with the card's 80 GB.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, RunConfig,
                                      get_config)
from repro_torch.launch import analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer

MESHES = ("pod1", "pod2", "pod3")


def arch_variant(arch, shape_name: str):
    """Shape-specific arch tweaks per the reference's input-shape policy."""
    if shape_name == "long_500k":
        if arch.family == "audio":
            return None, ("skip: enc-dec audio (1500-frame encoder, "
                          "448-token decoder)")
        if (arch.family in ("dense", "vlm") and arch.mla is None
                and arch.sliding_window == 0):
            arch = dataclasses.replace(arch, sliding_window=8192)
            return arch, "sliding-window 8192 variant (sub-quadratic policy)"
    return arch, ""


def skip_reason(arch, shape_name: str):
    if arch.family == "audio" and shape_name == "long_500k":
        return "enc-dec audio: no 500k decode"
    return None


def resolve_mesh(mesh, model: int | None = None) -> tuple:
    """``(recording world, name)`` of a hierarchy: ``"pod1"`` / ``"pod2"``
    / ``"pod3"`` (with the production ``model`` axis unless ``model``
    says otherwise) or a tuple of axis sizes (outermost first; ``model``
    default 1)."""
    if isinstance(mesh, str):
        m = mesh_lib.PRODUCTION_MODEL if model is None else int(model)
        return (mesh_lib.recording_world(
            mesh_lib.PRODUCTION_HIERARCHIES[mesh], model=m, device="meta"),
            mesh)
    sizes = tuple(int(s) for s in mesh)
    m = 1 if model is None else int(model)
    name = "x".join(map(str, sizes)) + (f"xmodel{m}" if m > 1 else "")
    return (mesh_lib.recording_world(sizes, model=m, device="meta"), name)


def _active_params(arch, n_params: int) -> float:
    """Active (per-token) parameter count: subtract non-selected experts."""
    if not arch.is_moe:
        return float(n_params)
    m = arch.moe
    # expert params per MoE layer (swiglu has the extra gate matrix)
    n_mats = 3 if arch.activation == "swiglu" else 2
    per_expert = arch.d_model * m.d_ff_expert * n_mats
    prefix, group, n_groups = transformer.layer_plan(arch)
    n_moe_layers = sum(1 for s in group if s.ffn == "moe") * n_groups
    inactive = n_moe_layers * (m.num_experts - m.top_k) * per_expert
    return float(n_params - inactive)


@dataclasses.dataclass
class DryRun:
    """What a dry-run leaves besides its record: the rank's collective
    inventory (``analysis.collective_check.Collective`` entries, in call
    order), how many of them the forward made, and the context."""

    inventory: list
    forward_calls: int
    ctx: object


def lower_one(arch_id: str, shape_name: str, mesh="pod1",
              aux_mode: str = "ta", optimized: bool = False, arch=None,
              shape: dict | None = None, model: int | None = None):
    """Returns ``(record, DryRun)``; the record holds every number.

    ``mesh``, ``model``: a hierarchy and model axis for
    :func:`resolve_mesh` (a family whose split widths the axis does not
    divide runs on the widest half of it that they do).  ``arch``: an
    ``ArchConfig`` to run instead of ``get_config(arch_id)`` (e.g. a
    ``reduced()`` one).  ``shape``: a dict of ``INPUT_SHAPES``' form to
    run instead of ``INPUT_SHAPES[shape_name]`` (``shape_name`` then
    only names it)."""
    from repro_torch.analysis import collective_check
    from repro_torch.core import capacity
    from repro_torch.core.dispatch import wire
    from repro_torch.optim import adamw
    from repro_torch.serving import engine
    from repro_torch.training import trainer

    arch0 = arch if arch is not None else get_config(arch_id)
    world, mesh_name = resolve_mesh(mesh, model)
    why = model_lib.tp_refusal(arch0, world.model)
    if why:
        m = world.model // 2
        while m > 1 and model_lib.tp_refusal(arch0, m):
            m //= 2
        why = f"model axis {world.model} -> {max(m, 1)}: {why}"
        world, mesh_name = resolve_mesh(mesh, max(m, 1))
    arch, note = arch_variant(arch0, shape_name)
    if why:
        note = "; ".join(filter(None, (note, why)))
    if arch is None or skip_reason(arch0, shape_name):
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "note": note or skip_reason(arch0, shape_name)}, None
    sh = shape if shape is not None else INPUT_SHAPES[shape_name]
    kind = sh["kind"]
    B, S = sh["global_batch"], sh["seq_len"]
    rows, replicated = model_lib.batch_rows(B, world)
    remat = kind == "train"
    mode = {"lb": "even", "ta": "ta", "hir": "hir"}[aux_mode]

    ctx = model_lib.build_ctx(arch, world, seq_len=S, global_batch=B,
                              aux_mode=aux_mode if arch.is_moe else "none",
                              remat=remat, decode_replicated=replicated,
                              use_pallas=False, device="meta")
    if optimized:
        ctx = dataclasses.replace(
            ctx, use_blockwise=True, fused_xent=True,
            wire_codec=wire.get_codec("fp8e4m3") if arch.is_moe else None,
            mamba_scan_chunk=512, xlstm_chunk=512)
        if kind == "prefill" and arch.is_moe:
            # inference prefill needs no drop headroom: cf 1.25 -> 1.0
            arch_cf1 = dataclasses.replace(
                arch, moe=dataclasses.replace(arch.moe, capacity_factor=1.0))
            ctx = dataclasses.replace(ctx, plan=model_lib.make_plan(
                arch_cf1, world, S, B, mode))
        if arch.is_moe and kind != "decode" and ctx.plan is not None:
            # comm-compute overlap: the pipelined dispatch at the overlap
            # model's chunk count (the reference's link ladder; a recording
            # world has no links to time)
            nc = model_lib.resolve_num_chunks(arch, ctx.plan, 0,
                                              wire_codec=ctx.wire_codec)
            ctx = dataclasses.replace(
                ctx, dispatch="a2a_pipelined", a2a_num_chunks=nc,
                plan=capacity.align_to_chunks(ctx.plan, nc))
    t0 = time.time()
    params = model_lib.abstract_params(ctx)
    n_params = model_lib.count_params(model_lib.abstract_params(
        dataclasses.replace(ctx, mesh=None)))
    specs = model_lib.input_specs(arch, sh, world, ctx=ctx)
    cost = analysis.CostMode()
    fwd_calls = 0
    if kind == "train":
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        def mark_backward():
            nonlocal fwd_calls
            fwd_calls = len(world.log)

        saved = analysis.SavedBytes(leaves, on_backward=mark_backward)
        run = RunConfig(seq_len=S, global_batch=B, aux_mode=aux_mode,
                        remat=remat)
        step = trainer.make_train_step(ctx, run)
        opt = adamw.init_state(params)
        with cost, saved.hooks():
            params, opt, _ = step(params, opt, specs)
        parts = analysis.state_bytes(params, opt)
        saved_bytes = saved.bytes
        if ctx.remat:
            # a checkpointed layer's own saved tensors never reach the
            # hooks (the checkpoint keeps its input [rows, S, d] instead,
            # and recomputes the rest): one input a layer
            saved_bytes += (len(transformer.layer_list(arch)) * rows * S
                            * arch.d_model * arch.torch_dtype.itemsize)
    else:
        if kind == "prefill":
            fn = engine.make_prefill(ctx)
            with cost:
                fn(params, specs)
        else:
            fn = engine.make_decode_step(ctx)
            with cost:
                fn(params, specs["cache"], specs["tokens"])
        fwd_calls = len(world.log)
        parts = {"params": analysis.tree_bytes(params),
                 "inputs": analysis.tree_bytes(specs)}
        saved_bytes = 0
    t_run = time.time() - t0

    inventory = collective_check.inventory(world)
    n_dev = world.size * world.model
    sizes = dict(zip(world.axis_names, world.axis_sizes))
    dpp = n_dev // sizes.get("pod", 1) // sizes.get("node", 1)
    stats = analysis.collective_stats(inventory, num_devices=n_dev,
                                      devices_per_pod=dpp)
    active = _active_params(arch, n_params)
    mf = analysis.model_flops_estimate(arch, S, B, kind, active)
    rl = analysis.roofline(cost.flops, cost.hbm_bytes, stats,
                           num_devices=n_dev, model_flops=mf)
    plan = getattr(ctx, "plan", None)
    arg_bytes = sum(parts.values())
    total = arg_bytes + saved_bytes
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "axis_sizes": list(world.axis_sizes),
        "status": "ok", "note": note, "kind": kind,
        "aux_mode": aux_mode, "optimized": optimized,
        "tensor_parallel": world.model, "batch_rows_per_rank": rows,
        "batch_replicated": replicated,
        "dispatch": ctx.dispatch, "a2a_num_chunks": ctx.a2a_num_chunks,
        "dispatch_levels": plan.num_stages if plan is not None else 0,
        "caps_by_level": list(plan.caps) if plan is not None else [],
        "n_params": n_params, "active_params": active,
        "params_per_rank": model_lib.count_params(params),
        "arg_bytes": arg_bytes, "arg_bytes_by_part": parts,
        "saved_bytes": saved_bytes,
        "bytes_per_device": total, "fits": total <= analysis.HBM_CAPACITY,
        "flops_per_chip": rl.flops_per_chip,
        "hbm_bytes_per_chip": rl.hbm_bytes_per_chip,
        "intra_node_bytes_per_chip": rl.intra_bytes_per_chip,
        "cross_node_bytes_per_chip": rl.cross_bytes_per_chip,
        "t_compute": rl.t_compute, "t_memory": rl.t_memory,
        "t_collective": rl.t_collective, "dominant": rl.dominant,
        "model_flops": mf, "useful_ratio": rl.useful_ratio,
        "collective_counts": rl.collective_counts, "aten_ops": cost.ops,
        "t_run_s": round(t_run, 1),
    }
    return rec, DryRun(inventory=inventory, forward_calls=fwd_calls, ctx=ctx)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="pod1",
                    choices=["pod1", "pod2", "pod3", "both", "all"])
    ap.add_argument("--aux-mode", default="ta", choices=["ta", "lb", "hir"])
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper perf flags (blockwise attention, "
                         "fused cross entropy, fp8 wire, pipelined "
                         "dispatch)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"pod1": ["pod1"], "pod2": ["pod2"], "pod3": ["pod3"],
              "both": ["pod1", "pod2"], "all": list(MESHES)}[args.mesh]

    failures = 0
    for arch_id in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                tag = f"{arch_id} x {shape_name} x {mesh_name}"
                try:
                    rec, _ = lower_one(arch_id, shape_name, mesh_name,
                                       aux_mode=args.aux_mode,
                                       optimized=args.opt)
                    if rec["status"] == "ok":
                        if rec.get("dispatch") == "a2a_pipelined":
                            tag += (f" [a2a_pipelined "
                                    f"chunks={rec['a2a_num_chunks']}]")
                        print(f"[ok] {tag}: dom={rec['dominant']} "
                              f"tC={rec['t_compute']*1e3:.2f}ms "
                              f"tM={rec['t_memory']*1e3:.2f}ms "
                              f"tX={rec['t_collective']*1e3:.2f}ms "
                              f"mem/dev={rec['bytes_per_device']/2**30:.2f}"
                              f"GiB fits={rec['fits']} "
                              f"(run {rec['t_run_s']}s)", flush=True)
                    else:
                        print(f"[skip] {tag}: {rec['note']}", flush=True)
                except Exception as e:
                    failures += 1
                    rec = {"arch": arch_id, "shape": shape_name,
                           "mesh": mesh_name, "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc(limit=4)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
