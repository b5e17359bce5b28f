"""The expert-parallel world: the counterpart of ``repro/launch/mesh.py``'s
``make_hierarchical_mesh`` and of ``sharding.hierarchy_axes`` for a group
of ``torch.distributed`` processes, one EP rank each.

Rank ``r`` has coordinates in row-major order over the outermost-first
axes (``capacity.default_axis_names``: ``("pod", "data")`` for two axes),
which is the device order of the reference's ``make_mesh((2, 2), ("pod",
"data"))``: rank ``r`` holds the batch rows that ``P(("pod", "data"))``
gives that device and the experts ``r * E_l : (r + 1) * E_l``.

The caller names the collective backend: ``"gloo"`` for ranks on the CPU
or sharing one card, ``"nccl"`` for one card a rank.  Nothing switches
backends on its own.  Under gloo every collective stages CUDA tensors
through pinned host buffers, so ranks may hold CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import socket

import torch
import torch.distributed as dist

from repro_torch.core.capacity import default_axis_names


@dataclasses.dataclass(frozen=True, eq=False)
class EPWorld:
    """This rank's view of the EP world: the axes (outermost first), their
    sizes, this rank's coordinates, and one process group per axis of
    size > 1 (the ranks that differ from this one only on that axis).
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
        staged = self._staged(src)
        if staged:
            src = self._to_host(src)
        out = torch.empty(src.shape, dtype=src.dtype, pin_memory=staged)
        dist.all_to_all_single(out, src, group=self.groups[axis])
        if staged:
            out = out.to(x.device)
        return out.movedim(0, dim)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over every rank of the world (a new tensor)."""
        if self.size == 1:
            return t
        buf = (self._to_host(t.detach()) if self._staged(t)
               else t.detach().clone())
        dist.all_reduce(buf)
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


def unit_world(device="cuda") -> EPWorld:
    """One rank, one ``data`` axis of size 1: no collective is ever run."""
    return EPWorld(axis_names=("data",), axis_sizes=(1,), coords=(0,),
                   device=str(device))


def make_hierarchical_mesh(axis_sizes, *, backend: str,
                           device="cuda") -> EPWorld:
    """The EP world over the default process group, which the caller has
    initialized (``dist.init_process_group``) with ``prod(axis_sizes)``
    ranks.  Every rank builds every per-axis group, in the same order, as
    ``dist.new_group`` requires."""
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
    for i, name in enumerate(names):
        if sizes[i] == 1:
            continue
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):
            members = []
            for c in range(sizes[i]):
                full = list(rest[:i]) + [c] + list(rest[i:])
                members.append(_rank_of(full, sizes))
            group = dist.new_group(ranks=members)
            if rank in members:
                groups[name] = group
    return EPWorld(axis_names=names, axis_sizes=sizes, coords=coords,
                   backend=backend, device=str(device), groups=groups)


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
