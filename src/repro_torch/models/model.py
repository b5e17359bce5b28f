"""Top-level model API: context building and parameter init (the
counterpart of ``repro/models/model.py``: ``default_rules``,
``make_ep_spec``, ``make_plan``, ``make_gate_cfg``, ``build_ctx``,
``param_spec_rules``, ``init_params``).

``mesh`` is the world of this rank (``launch.mesh.EPWorld``) or None for
one rank: its axes play the part of the reference's mesh hierarchy axes,
and its ``model`` axis (``EPWorld.model``) the reference's tensor-parallel
axis.  Parameters are this rank's: replicated tensors whole, expert
tensors the rank's shard of the expert axis, and under a model axis each
tensor that :func:`param_specs` shards over it the rank's slice
(:func:`shard_params`; :func:`gather_params` undoes it).  ``build_ctx``
takes the reference's keywords.  ``abstract_params`` and ``input_specs`` give the dry-run
(``launch/dryrun.py``) this rank's parameters and inputs as tensors on
the ``meta`` device: shapes and dtypes, no storage.
"""

from __future__ import annotations

import math
import re

import torch
from torch.overrides import TorchFunctionMode

from repro_torch import sharding
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig
from repro_torch.core import capacity, comm_model, gating, topology
from repro_torch.core.dispatch import base as moe_base
from repro_torch.core.dispatch import engine as dispatch_lib
from repro_torch.core.dispatch import wire
from repro_torch.models import transformer


def _hierarchy(mesh) -> tuple:
    """(axis names, axis sizes) of the EP world's hierarchy, outermost
    first; one ``data`` axis of size 1 without a world."""
    axes = sharding.hierarchy_axes(mesh)
    if mesh is None:
        return axes, (1,)
    return axes, tuple(mesh.shape[a] for a in axes)


def model_size(mesh) -> int:
    """The size of the world's tensor-parallel ``model`` axis (1 without
    one)."""
    return 1 if mesh is None else getattr(mesh, "model", 1)


def default_rules(mesh) -> sharding.AxisRules:
    """The logical-axis rules of a world (the reference's
    ``default_rules``): batch and experts over the hierarchy, ``model``
    over the model axis, ``kv_len`` over ``data``."""
    batch = sharding.hierarchy_axes(mesh)
    names = batch + (("model",) if model_size(mesh) > 1 else ())
    return sharding.AxisRules({
        "batch": batch if len(batch) > 1 else (batch[0] if batch else None),
        "model": "model" if "model" in names else None,
        "kv_len": "data" if "data" in names else None,
        "expert": batch if len(batch) > 1 else (batch[0] if batch else None),
    }, mesh=mesh)


def make_ep_spec(arch: ArchConfig, mesh=None) -> moe_base.EPSpec | None:
    """EP hierarchy for one world: experts span the longest *suffix* of
    the axes (innermost outward) whose extent divides the expert count —
    the whole hierarchy when possible, fewer tiers otherwise.  A world
    with a model axis above 1 names it as the spec's ``model_axis``."""
    if not arch.is_moe:
        return None
    axes, sizes = _hierarchy(mesh)
    while len(sizes) > 1 and sizes[0] == 1:   # degenerate outer tiers
        axes, sizes = axes[1:], sizes[1:]
    model = "model" if model_size(mesh) > 1 else None
    n = arch.moe.num_experts
    for k in range(len(axes)):                # longest suffix first
        world = math.prod(sizes[k:])
        if k == len(axes) - 1 or (n % world == 0 and n >= world):
            return moe_base.EPSpec.from_axes(axes[k:], sizes[k:],
                                             model_axis=model)
    return moe_base.EPSpec.from_axes(axes[-1:], sizes[-1:],
                                     model_axis=model)


def make_plan(arch: ArchConfig, mesh, seq_len: int, global_batch: int,
              mode: str) -> capacity.DispatchPlan | None:
    if not arch.is_moe:
        return None
    ep = make_ep_spec(arch, mesh)
    nshard = math.prod(_hierarchy(mesh)[1])
    tokens_per_device = max(1, (global_batch * seq_len) // nshard)
    return capacity.make_dispatch_plan(
        tokens_per_device=tokens_per_device,
        num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor,
        axis_sizes=ep.axis_sizes, axis_names=ep.axis_names, mode=mode,
        comm=topology.tree_topology_nd(ep.axis_sizes))


def make_gate_cfg(arch: ArchConfig, plan, ep, aux_mode: str,
                  ) -> gating.GateConfig | None:
    """Gate config; under ``aux_mode="ta"`` the Eq. (8) penalties come from
    the plan's full ratio vector and per-level member counts."""
    if not arch.is_moe:
        return None
    n_levels = max(3, len(plan.ratios) if plan is not None else 3)
    penalties = (1.0,) * n_levels
    if aux_mode == "ta" and plan is not None:
        penalties = gating.ta_penalties(plan.ratios,
                                        level_sizes=plan.level_sizes)
        if len(penalties) < 3:
            penalties = penalties + (penalties[-1],) * (3 - len(penalties))
    return gating.GateConfig(
        num_experts=arch.moe.num_experts, top_k=arch.moe.top_k,
        capacity_factor=arch.moe.capacity_factor, aux_mode=aux_mode,
        penalty_by_level=penalties)


def resolve_num_chunks(arch: ArchConfig, plan, num_chunks: int = 0, *,
                       links: dict | None = None, wire_codec=None) -> int:
    """Chunk count of the pipelined dispatch; 0 picks it with the overlap
    model (``comm_model``, the reference's link and peak constants, or the
    measured ``links`` of ``comm_model.measured_ep_links``).
    ``wire_codec`` rescales the exchange bytes to the wire encoding, so a
    codec swap can change the verdict."""
    if num_chunks > 0:
        return int(num_chunks)
    terms = comm_model.moe_overlap_terms(
        plan, d_model=arch.d_model, d_ff=arch.moe.d_ff_expert,
        bytes_per_el=2 if arch.torch_dtype == torch.bfloat16 else 4,
        activation=arch.activation, links=links, codec=wire_codec)
    return comm_model.choose_num_chunks(**terms)


def build_ctx(arch: ArchConfig, mesh=None, *, seq_len: int = 0,
              global_batch: int = 0, aux_mode: str = "ta",
              remat: bool = False, decode_replicated: bool = False,
              use_flash: bool = False, use_moe_kernel: bool = False,
              dispatch: str = "a2a", a2a_num_chunks: int = 0,
              dispatch_override: tuple = (), measured_comm: bool = False,
              use_pallas=None, wire_codec="", resilience=None,
              device="cuda") -> transformer.ModelCtx:
    """The model context.  ``seq_len`` / ``global_batch`` size the a2a
    capacity plan (tokens per rank = global tokens / world size).  When
    any layer takes ``a2a_pipelined``, ``a2a_num_chunks`` (0: the overlap
    model's pick, on links timed on ``mesh`` when ``measured_comm``; a
    collective then, called by every rank) sets the chunk count and the
    plan's capacities round up to a multiple of it.  ``remat`` recomputes
    each layer's forward in the backward.  ``resilience`` is accepted as
    the reference's is and read by nothing here: the training loop takes
    it from ``RunConfig``.  ``device`` is where parameters and caches
    live."""
    if aux_mode not in ("lb", "ta", "hir", "none"):
        raise ValueError(f"unknown aux_mode {aux_mode!r}")
    why = tp_refusal(arch, model_size(mesh), device=device,
                     use_pallas=use_pallas)
    if why:
        raise ValueError(f"{arch.name} on a model axis of "
                         f"{model_size(mesh)}: {why}")
    codec = wire.get_codec(wire_codec)
    if arch.is_moe and arch.moe.dispatch_override:
        merged = dict(arch.moe.dispatch_override)
        merged.update(dict(dispatch_override))
        dispatch_override = tuple(sorted(merged.items()))
    else:
        dispatch_override = tuple(sorted(dict(dispatch_override).items()))
    for name in (dispatch,) + tuple(n for _, n in dispatch_override):
        dispatch_lib.check_name(name)
    dispatch_mode = {"lb": "even", "ta": "ta", "hir": "hir",
                     "none": "even"}[aux_mode]
    plan = make_plan(arch, mesh, seq_len, global_batch, dispatch_mode)
    ep = make_ep_spec(arch, mesh)
    gate_cfg = make_gate_cfg(arch, plan, ep, aux_mode)
    num_chunks = 1
    pipelined = (dispatch == "a2a_pipelined"
                 or any(n == "a2a_pipelined" for _, n in dispatch_override))
    if plan is not None and pipelined:
        links = None
        if measured_comm and a2a_num_chunks <= 0:
            links = comm_model.measured_ep_links(mesh, ep.axis_names)
        num_chunks = resolve_num_chunks(arch, plan, a2a_num_chunks,
                                        links=links, wire_codec=codec)
        plan = capacity.align_to_chunks(plan, num_chunks)
    return transformer.ModelCtx(
        arch=arch, mesh=mesh, ep=ep, plan=plan, gate_cfg=gate_cfg,
        remat=remat, use_flash=use_flash, use_moe_kernel=use_moe_kernel,
        decode_replicated=decode_replicated, dispatch=dispatch,
        a2a_num_chunks=num_chunks, dispatch_override=dispatch_override,
        use_pallas=use_pallas, wire_codec=codec, device=str(device))


def tp_refusal(arch: ArchConfig, model: int, *, device=None,
               use_pallas=None) -> str:
    """Why ``arch`` cannot run on a model axis of ``model`` ("" when it
    can, and always at 1): a width that the port splits by and the axis
    does not divide, named with its leaves.  MLA's and the xLSTM
    mixers' heads, Mamba's inner dim, InternVL2's projector width and the
    expert width must divide (attention and the dense FFN are kept whole
    where theirs do not: ``ModelCtx.attn_sharded``, ``mlp_tp``).  With
    the kernels on ``device`` (``backend.kernels_active``) a model rank's
    expert width must also be a multiple of 64, which K3 and K4 need."""
    if model <= 1:
        return ""
    kinds = {s.mixer for s in transformer.layer_list(arch)}
    H = arch.num_heads
    if "mla" in kinds and H % model:
        return (f"MLA's {H} heads (mixer/w_q, mixer/w_u[kvq], mixer/w_o) "
                f"do not divide over it")
    if "mamba" in kinds:
        di = transformer.mamba_inner(arch)
        if di % model:
            return (f"Mamba's inner dim {di} (mixer/w_in, mixer/w_out) "
                    f"does not divide over it")
    if kinds & {"mlstm", "slstm"} and H % model:
        return (f"the xLSTM mixers' {H} heads (mixer/w_up, "
                f"mixer/w_gates) do not divide over it")
    if arch.frontend == "vision" and arch.d_model % model:
        return (f"InternVL2's projector width {arch.d_model} (proj/w1, "
                f"proj/w2) does not divide over it")
    if arch.is_moe:
        f = arch.moe.d_ff_expert
        if f % model:
            return f"the expert width {f} does not divide over it"
        from repro_torch.kernels import backend
        if (device is not None and (f // model) % 64
                and backend.kernels_active(use_pallas, device)):
            return (f"a model rank's expert width {f // model} (ffn/w_in, "
                    f"ffn/w_out) is not a multiple of 64, which K3 and K4 "
                    f"need")
    return ""


# ---------------------------------------------------------------------------
# parameter sharding rules (path regex -> spec)
# ---------------------------------------------------------------------------


def param_spec_rules(arch: ArchConfig, ep) -> list:
    """Ordered ``(regex, spec)`` rules for ``sharding.build_param_specs``:
    the reference's list (``repro/models/model.py:176-198``).  They are
    written for the stacked layout, a leading layer axis;
    ``build_param_specs`` fits them to the port's per-layer leaves."""
    exp = None
    if ep is not None:
        exp = ep.axis_names if len(ep.axis_names) > 1 else ep.axis_names[0]
    return [
        # embeddings: vocab over model axis
        (r"embed/table", ("model", None)),
        # MoE experts
        (r"ffn/w_in$", (None, exp, None, "model")),
        (r"ffn/w_gate$", (None, exp, None, "model")),
        (r"ffn/w_out$", (None, exp, "model", None)),
        (r"ffn/shared_(in|gate)", (None, None, "model")),
        (r"ffn/shared_out", (None, "model", None)),
        # attention projections (stacked: leading group axis)
        (r"mixer/w[qkv]$", (None, None, "model")),
        (r"(mixer|cross)/wo$", (None, "model", None)),
        (r"cross/w[qkv]$", (None, None, "model")),
        # MLA
        (r"mixer/w_u[kvq]$", (None, None, "model", None)),
        (r"mixer/w_q$", (None, None, "model", None)),
        # mamba / xlstm / mlp: shard the wide inner dim
        (r"mixer/w_in$", (None, None, "model")),
        (r"mixer/w_up$", (None, None, "model")),
        (r"mixer/(w_out|w_down)$", (None, "model", None)),
        (r"ffn/w_(in|gate)$", (None, None, "model")),
        (r"ffn/w_out$", (None, "model", None)),
        (r"proj/w1$", (None, "model")),
        (r"proj/w2$", ("model", None)),
    ]


#: attention leaves the port shards by heads only (see param_specs)
_ATTN_LEAF = re.compile(r"(^|/)(mixer|cross)/(w[qkvo]|b[qkv])$")
#: a dense FFN's leaves (2-D: an expert leaf has the expert axis first)
_MLP_LEAF = re.compile(r"(^|/)ffn/(w_in|w_gate|w_out)$")

_COLS, _ROWS = (None, "model"), ("model",)
#: the port's layouts of the mixers other than attention, by the
#: sublayer's mixer and the leaf's path below ``mixer/``
#: (:func:`param_specs`); a leaf not named is whole on every rank
MIXER_LAYOUTS = {
    # MLA by heads; the latent (w_dkv, kv_norm, w_kr, w_dq, q_norm) whole
    "mla": {"w_q": _COLS, "w_uq": _COLS, "w_uk": _COLS, "w_uv": _COLS,
            "w_o": _ROWS},
    # Mamba by inner channels: w_in's x and z stripes each split
    "mamba": {"w_in": (None, sharding.Stripes((True, True))),
              "conv_w": _COLS, "conv_b": _ROWS, "w_x_dbc": _ROWS,
              "w_dt": _COLS, "b_dt": _ROWS, "A_log": _ROWS, "D": _ROWS,
              "w_out": _ROWS},
    # mLSTM by heads: w_up's xu stripe whole (q, k, v and the gates read
    # all of it), its z stripe split; the per-head ln whole
    "mlstm": {"w_up": (None, sharding.Stripes((False, True))),
              "wq": _COLS, "wk": _COLS, "wv": _COLS,
              "w_if": (None, sharding.Stripes((True, True))),
              "b_if": (sharding.Stripes((True, True)),), "w_down": _ROWS},
    # sLSTM by heads: the four gate stripes of w_gates / b_gates each
    # split; ln (an RMSNorm over all of d) by the heads' channels
    "slstm": {"w_gates": (None, sharding.Stripes((True,) * 4)),
              "b_gates": (sharding.Stripes((True,) * 4),),
              "r_gates": _ROWS, "ln/scale": _ROWS, "w_out": _ROWS},
}


def _mixer_of(path: tuple, subs: list) -> str:
    """The mixer of the sublayer a leaf path lies in ("" outside one)."""
    if len(path) > 2 and path[0] == "layers":
        return subs[int(path[1])].mixer
    if len(path) > 2 and path[0] == "enc_layers":
        return "attn"
    return ""


def param_specs(params, ctx: transformer.ModelCtx):
    """The spec of every leaf of ``params`` (the full tree on the model
    dims, any expert shard) on ``ctx``'s world: the reference's rules
    through ``sharding.build_param_specs``, with layouts of the port's
    own where a rule's contiguous split would not run as one rank's
    part of the layer.

    - Attention (self, cross and the encoder's) by heads: ``wq``/``wk``/
      ``wv`` (and biases) by columns and ``wo`` by rows when the model
      axis divides the query and the KV heads (``ModelCtx.attn_sharded``),
      all four replicated otherwise (the reference splits columns
      whenever they divide, mid-head too).
    - A dense FFN's ``w_in``/``w_gate`` by columns and ``w_out`` by rows
      when the axis divides its width (the reference's expert rules match
      its leaves first, which leaves ``w_in`` whole and splits ``w_out``'s
      columns).
    - The other mixers by :data:`MIXER_LAYOUTS`.  MLA by heads with its
      latent leaves whole, as the reference's rule has it.  Mamba by
      inner channels: ``w_in``'s ``x`` and ``z`` stripes each split (the
      reference's contiguous column split would give one rank all of
      ``x``), the conv, ``w_dt``, ``b_dt``, ``A_log`` and ``D`` following
      the channels and ``w_x_dbc`` by rows (the reference keeps those
      whole).  The mLSTM by heads: ``w_up``'s ``xu`` stripe whole and
      its ``z`` stripe split, ``wq``/``wk``/``wv`` by head columns and
      ``w_if``'s two gate stripes split (the reference splits ``w_up``'s
      columns and keeps ``w_if`` whole).  The sLSTM by heads: the four
      gate stripes of ``w_gates`` and ``b_gates`` split, ``r_gates`` by
      heads, ``ln`` by channels (the reference keeps ``w_gates``,
      ``r_gates`` and ``ln`` whole).  InternVL2's projector keeps the
      reference's rule (``proj/w1`` by columns, ``proj/w2`` by rows)."""
    shape = sharding.mesh_shape(ctx.mesh) if ctx.mesh is not None else {}
    specs = sharding.build_param_specs(
        params, param_spec_rules(ctx.arch, ctx.ep), shape)
    flat = dict(sharding._leaves_with_paths(specs))
    attn, mlp = ctx.attn_sharded, ctx.mlp_tp is not None
    tp = ctx.tp is not None
    subs = transformer.layer_list(ctx.arch)

    def fix(path, leaf):
        ps = "/".join(path)
        spec = flat[path]
        mixer = _mixer_of(path, subs)
        if mixer in MIXER_LAYOUTS and path[2] == "mixer":
            return MIXER_LAYOUTS[mixer].get("/".join(path[3:]), ()) \
                if tp else ()
        m = _ATTN_LEAF.search(ps)
        if m is not None:
            if not attn:
                return ()
            name = m.group(3)
            return ("model",) if name == "wo" or name.startswith("b") \
                else (None, "model")
        m = _MLP_LEAF.search(ps)
        if m is not None and leaf.dim() == 2:
            if not mlp:
                return ()
            return ("model",) if m.group(2) == "w_out" else (None, "model")
        return spec

    return sharding._map_paths(params, fix)


def shard_params(params, ctx: transformer.ModelCtx):
    """This rank's slice of a parameter tree that is full on the model
    dims (``init_model``'s, or the reference's unstacked by
    ``convert.params_from_numpy``): every leaf :func:`param_specs`
    shards over ``model`` cut to its ``1 / model`` at this rank's model
    coordinate (each split stripe of a ``sharding.Stripes`` dimension
    cut, each whole one kept); the tree itself without a model axis."""
    m = model_size(ctx.mesh)
    if m == 1:
        return params
    flat = dict(sharding._leaves_with_paths(param_specs(params, ctx)))
    coord = ctx.mesh.model_coord
    return sharding._map_paths(
        params,
        lambda path, t: sharding.slice_for_model(t, flat[path], m, coord))


def gather_params(params, ctx: transformer.ModelCtx):
    """The inverse of :func:`shard_params` (a collective over the model
    axis, called by every rank): each model-sharded leaf's slices
    concatenated in model coordinate order, stripe by stripe; detached."""
    m = model_size(ctx.mesh)
    if m == 1:
        return params
    flat = dict(sharding._leaves_with_paths(
        param_specs(full_abstract_params(ctx), ctx)))

    def gather(path, t):
        spec = flat[path]
        dim = sharding.model_dim(spec)
        if dim is None:
            return t.detach()
        return sharding.unslice(sharding.gather_from_model(t, ctx.mesh, dim),
                                spec, m, dim)

    return sharding._map_paths(params, gather)


def init_params(ctx: transformer.ModelCtx, generator, device=None):
    """Fresh parameters from an explicit ``torch.Generator`` (which must
    live on ``device``, default ``ctx.device``).  Every rank draws the
    whole model from the same generator state and keeps its expert shard
    and its model slices, so replicated tensors agree across ranks and
    the global model does not depend on the world's shape.  Each layer is
    cut to the rank's slices as soon as it is drawn: a rank holds one
    whole layer at a time beside its slices."""
    m = model_size(ctx.mesh)
    if m == 1:
        return transformer.init_model(ctx, generator, device or ctx.device)
    flat = dict(sharding._leaves_with_paths(
        param_specs(full_abstract_params(ctx), ctx)))
    coord = ctx.mesh.model_coord

    def keep(prefix, tree):
        return sharding._map_paths(
            tree, lambda path, t: sharding.slice_for_model(
                t, flat[path], m, coord), prefix)

    params = transformer.init_model(ctx, generator, device or ctx.device,
                                    keep=keep)
    return {k: v if k in sharding.LAYER_LISTS else keep((k,), v)
            for k, v in params.items()}


def count_params(params) -> int:
    n = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        else:
            n += node.numel()
    return n


class _NoDraw(TorchFunctionMode):
    """Random draws become empty meta tensors of their shape and dtype:
    the initializers' shapes without a draw (a generator cannot draw into
    meta tensors)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.randn:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
            return torch.empty(*args, **kwargs)
        return func(*args, **kwargs)


def full_abstract_params(ctx: transformer.ModelCtx):
    """The rank's tree on the ``meta`` device before its model slicing
    (full on the model dims, the rank's expert shard): what
    :func:`param_specs` reads."""
    with _NoDraw():
        return transformer.init_model(ctx, None, "meta")


def abstract_params(ctx: transformer.ModelCtx):
    """This rank's parameter tree on the ``meta`` device: the shapes and
    dtypes :func:`init_params` gives, its expert shard and model slices
    included, with no allocation and no draw (the dry-run's
    parameters)."""
    return shard_params(full_abstract_params(ctx), ctx)


def batch_rows(B: int, world) -> tuple:
    """``(rows a rank, replicated)``: the global batch sharded over the
    world's ranks, or whole on every rank when it has fewer rows than
    ranks (the reference's context-parallel case, where the port keeps
    the whole batch and cache on every rank)."""
    n = 1 if world is None else world.size
    if B < n:
        return B, True
    if B % n:
        raise ValueError(f"global batch {B} does not divide over {n} ranks")
    return B // n, False


def input_specs(arch: ArchConfig, shape_name, world=None,
                ctx: transformer.ModelCtx | None = None) -> dict:
    """Meta tensors of every model input of one of ``INPUT_SHAPES`` (or
    a dict of its form) at this rank's shapes: ``tokens``/``labels``
    (int32) and ``loss_mask`` for ``train``, ``tokens`` for ``prefill``,
    one token a row and the cache (:func:`decode.init_cache` at the
    shape's length, which needs ``ctx``) for ``decode``; the frontend
    embeddings of an audio or vision model."""
    from repro_torch.models import decode as decode_lib
    sh = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
          else shape_name)
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    rows, _ = batch_rows(B, world)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {}
    if kind == "decode":
        if ctx is None:
            raise ValueError("decode specs need the model ctx (the cache)")
        specs["tokens"] = meta((rows, 1), torch.int32)
        specs["cache"] = decode_lib.init_cache(ctx, rows, S, device="meta")
        return specs
    specs["tokens"] = meta((rows, S), torch.int32)
    if kind == "train":
        specs["labels"] = meta((rows, S), torch.int32)
        specs["loss_mask"] = meta((rows, S), torch.float32)
    if arch.frontend == "vision":
        from repro_torch.models import vlm
        specs["frontend"] = meta(vlm.patch_shape(rows, arch), torch.float32)
    elif arch.frontend:
        from repro_torch.models import whisper
        specs["frontend"] = meta(whisper.frame_shape(rows, arch),
                                 torch.float32)
    return specs
