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

The caller names the collective backend: ``"gloo"`` for ranks on the CPU
or sharing one card, ``"nccl"`` for one card a rank.  Nothing switches
backends on its own.  Under gloo every collective stages CUDA tensors
through pinned host buffers, so ranks may hold CUDA tensors.  One-byte
float payloads (the fp8 wire) travel as their ``uint8`` bytes.
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
    ``backend`` is None for the unit world, which needs no process
    group."""

    axis_names: tuple
    axis_sizes: tuple
    coords: tuple
    backend: str | None = None
    device: str = "cuda"
    groups: dict = dataclasses.field(default_factory=dict)

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

    def _live(self, axes) -> tuple:
        """The axes of ``axes`` (None: all) with more than one rank, in
        the world's order."""
        names = self.axis_names if axes is None else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)

    def _group(self, live: tuple):
        """The process group over the axes ``live`` (``_live``'s result):
        None (the default group) when they are every axis of size > 1.
        A group's members, in group rank order, run in mixed-radix order
        over ``live`` (``make_hierarchical_mesh`` lists them so)."""
        if live == self._live(None):
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
        n = math.prod(self.shape[a] for a in live)
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


def make_hierarchical_mesh(axis_sizes, *, backend: str,
                           device="cuda") -> EPWorld:
    """The EP world over the default process group, which the caller has
    initialized (``dist.init_process_group``) with ``prod(axis_sizes)``
    ranks.  Every rank builds every group (each axis, then each set of two
    or more axes short of the world, smaller sets first), in the same
    order, as ``dist.new_group`` requires."""
    sizes = tuple(int(s) for s in axis_sizes)
    names = default_axis_names(len(sizes))
    if not dist.is_initialized():
        raise RuntimeError("make_hierarchical_mesh needs an initialized "
                           "torch.distributed process group")
    if dist.get_world_size() != math.prod(sizes):
        raise ValueError(f"axis sizes {sizes} need {math.prod(sizes)} ranks, "
                         f"the process group has {dist.get_world_size()}")
    rank = dist.get_rank()
    coords, r = [], rank
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    groups = {}
    live = [i for i, s in enumerate(sizes) if s > 1]
    for k in range(1, max(2, len(live))):
        for span in itertools.combinations(live, k):
            key = names[span[0]] if k == 1 else tuple(names[i] for i in span)
            fixed = [i for i in range(len(sizes)) if i not in span]
            for rest in itertools.product(*(range(sizes[i]) for i in fixed)):
                members = []
                for inner in itertools.product(*(range(sizes[i])
                                                 for i in span)):
                    full = [0] * len(sizes)
                    for i, c in zip(fixed, rest):
                        full[i] = c
                    for i, c in zip(span, inner):
                        full[i] = c
                    members.append(_rank_of(full, sizes))
                group = dist.new_group(ranks=members)
                if rank in members:
                    groups[key] = group
    return EPWorld(axis_names=names, axis_sizes=sizes, coords=coords,
                   backend=backend, device=str(device), groups=groups)


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


def _rank_main(rank, fn, axis_sizes, backend, device, port, args):
    world_size = math.prod(axis_sizes)
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
                                       device=device)
        fn(world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, axis_sizes, backend: str, device="cuda", args=()) -> None:
    """Run ``fn(world, *args)`` on ``prod(axis_sizes)`` new processes, one
    EP rank each, over ``tcp://localhost`` on a free port.  ``fn`` must be
    importable by name (a module-level function).  Raises if any rank
    fails; the other ranks are then terminated."""
    import torch.multiprocessing as mp
    sizes = tuple(int(s) for s in axis_sizes)
    mp.spawn(_rank_main, args=(fn, sizes, backend, str(device), free_port(),
                               tuple(args)),
             nprocs=math.prod(sizes), join=True)
