"""The expert-parallel world: the counterpart of ``repro/launch/mesh.py``'s
``make_hierarchical_mesh`` and of ``sharding.hierarchy_axes`` for a group
of ``torch.distributed`` processes, one EP rank each.

Rank ``r`` has coordinates in row-major order over the outermost-first
axes (``capacity.default_axis_names``: ``("pod", "data")`` for two axes,
``("pod", "node", "data")`` for three), which is the device order of the
reference's ``make_mesh((2, 2), ("pod", "data"))``: rank ``r`` holds the
batch rows that ``P(("pod", "data"))`` gives that device.  The experts
span a suffix of the axes (``models.model.make_ep_spec``); a rank holds
the expert shard of its coordinates on those axes, and the axes above
them are pure data parallelism.

A world may add a tensor-parallel ``model`` axis (``EPWorld.model``
ranks, the reference's innermost mesh axis): it stays out of
``axis_names`` / ``axis_sizes``, which keep naming the hierarchy, so
``rank``, ``size`` and every EP and data-parallel collective are those
of the hierarchy with this rank's model coordinate fixed.  Process ``p``
of the world is hierarchy rank ``p // model`` at model coordinate ``p %
model``, and the ``"model"`` axis (``all_reduce_sum(t, ("model",))``,
``all_gather(t, "model")``) joins the ranks that differ only there.

The caller names the collective backend: ``"gloo"`` for ranks on the CPU
or sharing one card, ``"nccl"`` for one card a rank.  Nothing switches
backends on its own.  Under gloo every collective stages CUDA tensors
through pinned host buffers, so ranks may hold CUDA tensors.  One-byte
float payloads (the fp8 wire) travel as their ``uint8`` bytes.

:class:`RecordingWorld` wraps ``EPWorld``'s three collectives and logs
each call (the static analysis's collective inventory and the dry-run's
traffic): alone it emulates one rank of a world in one process (its
collectives return tensors of the right shape without communicating),
around a real world it passes every call through.  The production
hierarchies (``make_production_mesh``, ``make_production_mesh_3tier``)
are the reference's meshes, their 16-wide ``model`` axis included, as
recording worlds at the coordinates of rank 0.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.core.capacity import default_axis_names
from repro_torch.core.topology import axis_sizes_from_spec


@dataclasses.dataclass(frozen=True, eq=False)
class EPWorld:
    """This rank's view of the EP world: the axes (outermost first), their
    sizes, this rank's coordinates, and its process groups: one per axis
    of size > 1 (keyed by the axis name: the ranks that differ from this
    one only on that axis) and one per set of two or more such axes short
    of the whole world (keyed by the tuple of names, outermost first).
    ``model`` is the size of the tensor-parallel axis and ``model_coord``
    this rank's place on it; with ``model`` > 1 the groups of the
    hierarchy axes hold this model coordinate's ranks, the whole
    hierarchy has one too, and ``"model"`` keys the model axis's group.
    ``backend`` is None for the unit world, which needs no process
    group."""

    axis_names: tuple
    axis_sizes: tuple
    coords: tuple
    backend: str | None = None
    device: str = "cuda"
    groups: dict = dataclasses.field(default_factory=dict)
    model: int = 1
    model_coord: int = 0

    @property
    def process_rank(self) -> int:
        """This process's rank in the default group (model innermost)."""
        return self.rank * self.model + self.model_coord

    @property
    def every_axis(self) -> tuple:
        """Every axis of the world, the ``model`` axis last: the ``axes``
        of a collective over all of its processes."""
        return self.axis_names + ("model",)

    @property
    def rank(self) -> int:
        r = 0
        for c, s in zip(self.coords, self.axis_sizes):
            r = r * s + c
        return r

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def coords_of(self, axes) -> tuple:
        """This rank's coordinates on ``axes`` (names, outermost first)."""
        at = dict(zip(self.axis_names, self.coords))
        return tuple(at[a] for a in axes)

    def _size(self, axis: str) -> int:
        return self.model if axis == "model" else self.shape[axis]

    def _live(self, axes) -> tuple:
        """The axes of ``axes`` (None: every hierarchy axis) with more
        than one rank, in the world's order, ``model`` last."""
        names = self.axis_names if axes is None else tuple(axes)
        return tuple(a for a in self.axis_names + ("model",)
                     if a in names and self._size(a) > 1)

    def _group(self, live: tuple):
        """The process group over the axes ``live`` (``_live``'s result):
        None (the default group) when they are every axis of size > 1,
        the model axis included.  A group's members, in group rank
        order, run in mixed-radix order over ``live``
        (``make_hierarchical_mesh`` lists them so)."""
        if live == self._live(self.every_axis):
            return None
        return self.groups[live[0] if len(live) == 1 else live]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of a device tensor (gloo moves host
        memory)."""
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def all_to_all(self, x: torch.Tensor, axis: str, dim: int):
        """JAX's tiled ``all_to_all(split_axis=dim, concat_axis=dim)``
        over ``axis``: ``x.shape[dim]`` equals the axis size; slice ``j``
        goes to the member with coordinate ``j``, and slice ``j`` of the
        result came from it."""
        n = self.shape[axis]
        if n == 1:
            return x
        if x.shape[dim] != n:
            raise ValueError(f"all_to_all over {axis!r} ({n} ranks) needs "
                             f"dim {dim} of size {n}, got {tuple(x.shape)}")
        src = x.movedim(dim, 0).contiguous()
        if src.dtype.is_floating_point and src.dtype.itemsize == 1:
            src = src.view(torch.uint8)      # gloo has no float8 types
        staged = self._staged(src)
        if staged:
            src = self._to_host(src)
        out = torch.empty(src.shape, dtype=src.dtype, pin_memory=staged)
        dist.all_to_all_single(out, src, group=self.groups[axis])
        if staged:
            out = out.to(x.device)
        return out.view(x.dtype).movedim(0, dim)

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """JAX's tiled ``all_gather(axis=0, tiled=True)`` over ``axes`` (a
        name or a tuple of names) in one collective: the members' ``x``
        concatenated on dim 0 in their mixed-radix order over ``axes``,
        outermost first, which is the order of gathering the innermost
        axis first."""
        live = self._live((axes,) if isinstance(axes, str) else axes)
        if not live:
            return x
        n = math.prod(self._size(a) for a in live)
        src = x.detach().contiguous()
        if src.dtype.is_floating_point and src.dtype.itemsize == 1:
            src = src.view(torch.uint8)      # gloo has no float8 types
        staged = self._staged(src)
        if staged:
            src = self._to_host(src)
        parts = [torch.empty(src.shape, dtype=src.dtype, pin_memory=staged)
                 for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(live))
        out = torch.cat(parts, dim=0)
        if staged:
            out = out.to(x.device)
        return out.view(x.dtype)

    def all_reduce_sum(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """Sum of ``t`` over the ranks that differ from this one only on
        ``axes`` (names; None: every rank of the world).  A new tensor,
        except where ``axes`` spans one rank, which returns ``t``."""
        live = self._live(axes)
        if not live:
            return t
        buf = (self._to_host(t.detach()) if self._staged(t)
               else t.detach().clone())
        dist.all_reduce(buf, group=self._group(live))
        return buf.to(t.device)

    def mean(self, metrics: dict) -> dict:
        """World means of a dict of tensors, detached, in one all-reduce."""
        parts = [v.detach().to(torch.float32).reshape(-1)
                 for v in metrics.values()]
        vec = self.all_reduce_sum(torch.cat(parts)) / self.size
        out, off = {}, 0
        for (k, v), p in zip(metrics.items(), parts):
            out[k] = vec[off:off + p.numel()].reshape(v.shape)
            off += p.numel()
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class RecordingWorld(EPWorld):
    """An :class:`EPWorld` that appends each collective it is asked for to
    ``log`` as ``(kind, dtype, elements, axes)``: ``"all_to_all"``,
    ``"all_gather"`` or ``"all_reduce"``, the dtype and element count of
    the tensor handed in, and the axes of size > 1 it spans (a collective
    over one rank is none, as in ``EPWorld``).  With ``inner`` (the
    rank's real world, whose fields it shares) the call then runs there;
    without, the world is emulated in one process: ``all_to_all`` returns
    its input (a rank's own counts are valid counts, so control flow that
    reads them runs as on a real rank), ``all_gather`` the input tiled,
    ``all_reduce_sum`` a copy.  Meta tensors pass through both."""

    inner: EPWorld | None = None
    log: list = dataclasses.field(default_factory=list)

    def _record(self, kind: str, t: torch.Tensor, live: tuple) -> None:
        self.log.append((kind, t.dtype, t.numel(), live))

    def all_to_all(self, x: torch.Tensor, axis: str, dim: int):
        n = self.shape[axis]
        if n == 1:
            return x
        if x.shape[dim] != n:
            raise ValueError(f"all_to_all over {axis!r} ({n} ranks) needs "
                             f"dim {dim} of size {n}, got {tuple(x.shape)}")
        self._record("all_to_all", x, (axis,))
        if self.inner is not None:
            return self.inner.all_to_all(x, axis, dim)
        return x

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        live = self._live((axes,) if isinstance(axes, str) else axes)
        if not live:
            return x
        self._record("all_gather", x, live)
        if self.inner is not None:
            return self.inner.all_gather(x, axes)
        n = math.prod(self._size(a) for a in live)
        return x.detach().repeat((n,) + (1,) * (x.dim() - 1))

    def all_reduce_sum(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        live = self._live(axes)
        if not live:
            return t
        self._record("all_reduce", t, live)
        if self.inner is not None:
            return self.inner.all_reduce_sum(t, axes)
        return t.detach().clone()


def recording_world(axis_sizes=None, *, inner: EPWorld | None = None,
                    model: int = 1, device="cpu") -> RecordingWorld:
    """A :class:`RecordingWorld`: around ``inner`` (its axes, coordinates,
    backend and groups), or alone over ``axis_sizes`` (outermost first,
    ``capacity.default_axis_names``) and a ``model`` axis, at the
    coordinates of rank 0."""
    if inner is not None:
        return RecordingWorld(
            axis_names=inner.axis_names, axis_sizes=inner.axis_sizes,
            coords=inner.coords, backend=inner.backend, device=inner.device,
            groups=inner.groups, model=inner.model,
            model_coord=inner.model_coord, inner=inner)
    sizes = tuple(int(s) for s in axis_sizes)
    return RecordingWorld(axis_names=default_axis_names(len(sizes)),
                          axis_sizes=sizes, coords=(0,) * len(sizes),
                          device=str(device), model=int(model))


#: the reference's production meshes (``repro/launch/mesh.py:20-31``):
#: the hierarchy axes, outermost first, and the 16-wide ``model`` axis
PRODUCTION_HIERARCHIES = {"pod1": (16,), "pod2": (2, 16), "pod3": (2, 2, 8)}
PRODUCTION_MODEL = 16


def make_production_mesh(*, multi_pod: bool = False,
                         device="cpu") -> RecordingWorld:
    """pod1 (``data`` 16) or pod2 (``pod`` 2 x ``data`` 16), each with a
    ``model`` axis (16), emulated at rank 0 by a
    :class:`RecordingWorld`."""
    return recording_world(
        PRODUCTION_HIERARCHIES["pod2" if multi_pod else "pod1"],
        model=PRODUCTION_MODEL, device=device)


def make_production_mesh_3tier(device="cpu") -> RecordingWorld:
    """pod3: ``pod`` 2 x ``node`` 2 x ``data`` 8 with a ``model`` axis,
    emulated at rank 0."""
    return recording_world(PRODUCTION_HIERARCHIES["pod3"],
                           model=PRODUCTION_MODEL, device=device)


def gather_rows(world, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated on dim 0 in world rank order (one
    all-gather over every axis); ``t`` itself without a world."""
    if world is None:
        return t
    return world.all_gather(t, world.axis_names)


def unit_world(device="cuda") -> EPWorld:
    """One rank, one ``data`` axis of size 1: no collective is ever run."""
    return EPWorld(axis_names=("data",), axis_sizes=(1,), coords=(0,),
                   device=str(device))


def make_hierarchical_mesh(axis_sizes, *, backend: str, device="cuda",
                           model: int = 1) -> EPWorld:
    """The EP world over the default process group, which the caller has
    initialized (``dist.init_process_group``) with ``prod(axis_sizes) *
    model`` ranks, the ``model`` axis innermost.  Every rank builds every
    group (each hierarchy axis, then each set of two or more of them
    short of the whole hierarchy, smaller sets first; with a model axis
    the whole hierarchy too, then the model axis), in the same order, as
    ``dist.new_group`` requires."""
    sizes = tuple(int(s) for s in axis_sizes)
    model = int(model)
    names = default_axis_names(len(sizes))
    if not dist.is_initialized():
        raise RuntimeError("make_hierarchical_mesh needs an initialized "
                           "torch.distributed process group")
    if dist.get_world_size() != math.prod(sizes) * model:
        raise ValueError(f"axis sizes {sizes} and a model axis of {model} "
                         f"need {math.prod(sizes) * model} ranks, the "
                         f"process group has {dist.get_world_size()}")
    full_sizes = sizes + (model,)
    rank = dist.get_rank()
    coords, r = [], rank
    for s in reversed(full_sizes):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    live = [i for i, s in enumerate(sizes) if s > 1]
    spans = [span for k in range(1, (len(live) + 1 if model > 1
                                     else max(2, len(live))))
             for span in itertools.combinations(live, k)]
    if model > 1:
        spans.append((len(sizes),))
    groups = {}
    for span in spans:
        key = ("model" if span == (len(sizes),) else
               names[span[0]] if len(span) == 1 else
               tuple(names[i] for i in span))
        fixed = [i for i in range(len(full_sizes)) if i not in span]
        for rest in itertools.product(*(range(full_sizes[i])
                                        for i in fixed)):
            members = []
            for inner in itertools.product(*(range(full_sizes[i])
                                             for i in span)):
                full = [0] * len(full_sizes)
                for i, c in zip(fixed, rest):
                    full[i] = c
                for i, c in zip(span, inner):
                    full[i] = c
                members.append(_rank_of(full, full_sizes))
            group = dist.new_group(ranks=members)
            if rank in members:
                groups[key] = group
    return EPWorld(axis_names=names, axis_sizes=sizes, coords=coords[:-1],
                   backend=backend, device=str(device), groups=groups,
                   model=model, model_coord=coords[-1])


def mesh_from_topology(spec) -> tuple:
    """The world's axis sizes (outermost first) for a paper-notation
    nested topology spec (Fig. 2), the counterpart of the reference's
    ``mesh_from_topology``: ``[[2, 2], [2, 2]]`` -> ``(2, 2, 2)``, axes
    ``("pod", "node", "data")``; asymmetric specs are merged first (paper
    §4.2).  ``spawn`` and ``make_hierarchical_mesh`` take the sizes."""
    return axis_sizes_from_spec(spec)


def _rank_of(coords, sizes) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, axis_sizes, backend, device, port, args,
               model=1):
    world_size = math.prod(axis_sizes) * model
    if backend == "nccl":                    # one card a rank
        device = f"cuda:{rank}"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if dev.type == "cpu":
        # the ranks share the host's cores: each with a thread a core
        # would oversubscribe them world_size times over
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                                  // world_size))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    try:
        world = make_hierarchical_mesh(axis_sizes, backend=backend,
                                       device=device, model=model)
        fn(world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, axis_sizes, backend: str, device="cuda", args=(),
          model: int = 1) -> None:
    """Run ``fn(world, *args)`` on ``prod(axis_sizes) * model`` new
    processes, one rank each (``model`` > 1 adds the tensor-parallel
    axis, innermost), over ``tcp://localhost`` on a free port.  ``fn`` must be
    importable by name (a module-level function).  Raises if any rank
    fails; the other ranks are then terminated."""
    import torch.multiprocessing as mp
    sizes = tuple(int(s) for s in axis_sizes)
    mp.spawn(_rank_main, args=(fn, sizes, backend, str(device), free_port(),
                               tuple(args), int(model)),
             nprocs=math.prod(sizes) * int(model), join=True)
