"""Logical-axis rules, path-based parameter specs and the two conjugate
operations of tensor parallelism (the counterpart of
``repro/sharding.py``).

A spec is a tuple with one entry per leading dimension of a tensor: a
world axis name (``"model"``, ``"data"``, ...), a tuple of names, or None
(replicated along that dimension); trailing None entries are dropped, so
``()`` is fully replicated.  Model code names *logical* axes ("batch",
"model", "expert", "kv_len"); the active :class:`AxisRules` maps them to
world axes.

The reference's ``constrain`` (a ``with_sharding_constraint`` that lets
GSPMD place the collectives) has no counterpart: the port's parallelism
is explicit.  Each column-parallel product is preceded by
:func:`copy_to_model` (identity forward, all-reduce of the gradient over
the ``model`` axis) and each row-parallel product is followed by
:func:`reduce_from_model` (all-reduce forward, identity backward), and
both run through the world's ``EPWorld`` collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading

import torch

_state = threading.local()


class AxisRules:
    """Logical axis name -> world axis (a name, a tuple of names or
    None), with the world (``launch.mesh.EPWorld``) that sizes them."""

    def __init__(self, mapping: dict, mesh=None):
        self.mapping = dict(mapping)
        self.mesh = mesh

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        return self.mapping.get(logical)

    def axis_size(self, logical: str) -> int:
        ax = self.resolve(logical)
        if ax is None or self.mesh is None:
            return 1
        shape = mesh_shape(self.mesh)
        n = 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            n *= shape.get(a, 1)
        return n


def mesh_shape(world) -> dict:
    """Every axis of ``world`` with its size, the ``model`` axis last
    (the reference's ``mesh.shape``)."""
    shape = dict(zip(world.axis_names, world.axis_sizes))
    shape["model"] = getattr(world, "model", 1)
    return shape


def hierarchy_axes(world) -> tuple:
    """The world's batch/expert hierarchy axes, outermost first: every
    axis but the tensor-parallel ``model`` axis (``("data",)``, ``("pod",
    "data")``, ``("pod", "node", "data")``); ``("data",)`` without a
    world.  The one place the EP and data-parallel code take their axis
    order from."""
    if world is None:
        return ("data",)
    return tuple(a for a in world.axis_names if a != "model")


def current_rules() -> AxisRules | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: AxisRules):
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def logical_spec(*logical_axes, dims=None) -> tuple:
    """Spec from logical axis names under the active rules (``()``
    without).  ``dims``: concrete sizes; an axis whose size its world
    extent does not divide is replicated (6 heads on a 16-wide model
    axis)."""
    rules = current_rules()
    if rules is None:
        return ()
    out = []
    for i, name in enumerate(logical_axes):
        ax = rules.resolve(name)
        if ax is not None and dims is not None:
            if dims[i] % rules.axis_size(name) != 0:
                ax = None
        out.append(ax)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter specs by tree path
# ---------------------------------------------------------------------------


def _leaves_with_paths(tree, prefix=()):
    """``(path, leaf)`` pairs of a tree of dicts and lists (a tuple is a
    leaf: specs are tuples)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _map_paths(tree, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(v, fn, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


#: the port's per-layer lists: a rule is written for the reference's
#: stacked layout (a leading layer axis), which these leaves lack
LAYER_LISTS = ("layers", "enc_layers")


def build_param_specs(params, rules: list, shape: dict | None = None):
    """A spec for every leaf, by regex on its ``/``-joined path
    (``layers/3/mixer/wq``): ``rules`` is an ordered list of ``(regex,
    spec)``, the first match wins, and the default is replicated.  A
    spec is fitted to the leaf (:func:`_fit_spec`: entries past its rank
    dropped, an axis whose extent does not divide the dimension
    replicated).  Leaves of the per-layer lists (:data:`LAYER_LISTS`)
    are fitted as the reference's stacked leaf would be, one leading
    layer axis prepended, which is then dropped.  ``shape`` (axis name ->
    size) defaults to the active rules' world."""
    compiled = [(re.compile(rx), spec) for rx, spec in rules]
    if shape is None:
        r = current_rules()
        shape = mesh_shape(r.mesh) if r is not None and r.mesh is not None \
            else None

    def assign(path, leaf):
        ps = "/".join(path)
        stacked = len(path) > 1 and path[0] in LAYER_LISTS
        for rx, spec in compiled:
            if rx.search(ps):
                dims = tuple(leaf.shape)
                if stacked:
                    return _fit_spec(spec, (1,) + dims, shape)[1:]
                return _fit_spec(spec, dims, shape)
        return ()

    return _map_paths(params, assign)


def _fit_spec(spec: tuple, dims: tuple, shape: dict | None) -> tuple:
    """Trim and repair ``spec`` against a leaf of sizes ``dims``."""
    out = []
    for i, ax in enumerate(spec):
        if i >= len(dims):
            break
        if ax is None or shape is None:
            out.append(ax)
            continue
        extent = 1
        for a in ((ax,) if isinstance(ax, str) else tuple(ax)):
            extent *= shape.get(a, 1)
        out.append(ax if dims[i] % extent == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Stripes:
    """A spec entry for a dimension that packs ``len(parts)`` equal
    stripes side by side (Mamba's ``x`` and ``z`` in ``w_in``, sLSTM's
    four gates in ``w_gates``): each stripe is split over the ``model``
    axis (True) or kept whole on every rank (False), and a rank's slice
    is the concatenation of its stripes in order.  A plain ``"model"``
    entry is ``Stripes((True,))``."""

    parts: tuple

    def __post_init__(self):
        if not any(self.parts):
            raise ValueError("a Stripes entry splits at least one stripe")


def model_dim(spec: tuple) -> int | None:
    """The dimension a spec shards over the ``model`` axis, or None."""
    for i, ax in enumerate(spec):
        if ax == "model" or isinstance(ax, Stripes) or (
                isinstance(ax, tuple) and "model" in ax):
            return i
    return None


def stripes_of(spec: tuple) -> tuple:
    """The stripe pattern of a spec's model dimension (``(True,)`` for a
    plain split, ``()`` when nothing is split)."""
    dim = model_dim(spec)
    if dim is None:
        return ()
    ax = spec[dim]
    return ax.parts if isinstance(ax, Stripes) else (True,)


def slice_for_model(t: torch.Tensor, spec: tuple, m: int, coord: int):
    """Model rank ``coord``'s slice (of ``m``) of a tensor that is full
    on the model dims: each split stripe of the model dimension cut to
    its ``1 / m`` at ``coord``, each whole stripe kept; ``t`` itself when
    the spec splits nothing."""
    dim = model_dim(spec)
    if dim is None:
        return t
    parts = stripes_of(spec)
    w = t.shape[dim] // len(parts)
    out = []
    for j, split in enumerate(parts):
        stripe = t.narrow(dim, j * w, w)
        out.append(stripe.narrow(dim, coord * (w // m), w // m)
                   if split else stripe)
    return torch.cat(out, dim).clone() if len(out) > 1 else out[0].clone()


def _stripe_spans(parts: tuple, local: int, m: int) -> list:
    """``(offset, width, split)`` of each stripe within a rank's slice of
    ``local`` entries: whole stripes ``w`` wide, split ones ``w / m``."""
    n_split = sum(parts)
    w = local * m // ((len(parts) - n_split) * m + n_split)
    spans, off = [], 0
    for split in parts:
        width = w // m if split else w
        spans.append((off, width, split))
        off += width
    return spans


def unslice(shards: torch.Tensor, spec: tuple, m: int, dim: int):
    """The full tensor from ``shards``, the ``m`` ranks' slices
    concatenated on ``dim`` in model coordinate order (what
    :func:`gather_from_model` returns): split stripes joined across the
    ranks, whole stripes taken from rank 0."""
    parts = stripes_of(spec)
    if parts == (True,):
        return shards
    local = shards.shape[dim] // m
    out = []
    for off, width, split in _stripe_spans(parts, local, m):
        if split:
            out.extend(shards.narrow(dim, r * local + off, width)
                       for r in range(m))
        else:
            out.append(shards.narrow(dim, off, width))
    return torch.cat(out, dim)


def split_squares(g: torch.Tensor, spec: tuple, m: int) -> tuple:
    """``(split, whole)``: float32 sums of squares of a rank's slice
    ``g`` (of ``m``) over its split stripes and over its whole ones
    (None where it has none).  The first sums over the model axis to the
    full tensor's share; the second is the same on every rank and counts
    once."""
    sq = torch.square(g.to(torch.float32))
    parts = stripes_of(spec)
    if not parts:
        return None, sq.sum()
    if all(parts):
        return sq.sum(), None
    dim = model_dim(spec)
    split = whole = 0.0
    for off, width, is_split in _stripe_spans(parts, g.shape[dim], m):
        part = sq.narrow(dim, off, width).sum()
        if is_split:
            split = split + part
        else:
            whole = whole + part
    return split, whole


# ---------------------------------------------------------------------------
# the conjugate operations of tensor parallelism
# ---------------------------------------------------------------------------


def tp_world(world):
    """``world`` when it has a ``model`` axis of more than one rank, else
    None (the operations below are then identities)."""
    if world is None or getattr(world, "model", 1) <= 1:
        return None
    return world


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.world.all_reduce_sum(g.contiguous(), ("model",)), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        return world.all_reduce_sum(x.contiguous(), ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, world) -> torch.Tensor:
    """Before a column-parallel product: ``x`` (the same on every model
    rank) unchanged, its gradient summed over the ``model`` axis (each
    rank's is the part its column shard sees)."""
    w = tp_world(world)
    if w is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, w)


def reduce_from_model(x: torch.Tensor, world) -> torch.Tensor:
    """After a row-parallel product: the sum of the ranks' partial
    products over the ``model`` axis; the gradient passes unchanged."""
    w = tp_world(world)
    if w is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, w)
    return w.all_reduce_sum(x.contiguous(), ("model",))


def gather_from_model(x: torch.Tensor, world, dim: int = -1) -> torch.Tensor:
    """The ranks' shards of ``x`` concatenated on ``dim`` in model
    coordinate order (no gradient: serving's logits)."""
    w = tp_world(world)
    if w is None:
        return x
    t = x.detach().movedim(dim, 0).contiguous()
    return w.all_gather(t, ("model",)).movedim(0, dim)
