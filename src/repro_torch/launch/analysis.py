"""The dry-run's cost accounting and roofline terms (the counterpart of
``repro/launch/analysis.py``).

The reference reads FLOPs and HBM bytes from XLA's ``cost_analysis`` and
parses the collectives out of the compiled HLO.  The port has no
compiler: :class:`CostMode` counts FLOPs with ``torch.utils.flop_counter``'s
formulas and HBM bytes as every ATen op's tensor inputs plus outputs
(views move nothing; an eager program reads and writes each op's tensors
once, which is what the card's memory sees without fusion), and
:func:`collective_stats` sums the wire bytes of the collectives a
``launch.mesh.RecordingWorld`` logged, with the reference's per-kind
factors, split into the links inside a node and between nodes.

The constants are an NVIDIA H100 SXM5's; :func:`roofline` uses them and
nothing else (``core/comm_model.py`` and ``core/topology.py`` keep the
reference's link ladder for the capacity plan, which must not move).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 (data sheet, NVIDIA H100 Tensor Core GPU, 2023)
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4: 900 GB/s a GPU, 450 GB/s a direction
NET_BW = 400e9 / 8           # one 400 Gb/s NDR InfiniBand port a GPU
HBM_CAPACITY = 80e9          # the card's 80 GB

# the reference's HLO collective kinds, by the recording's names
_KIND = {"all_to_all": "all-to-all", "all_gather": "all-gather",
         "all_reduce": "all-reduce"}


@dataclasses.dataclass
class CollectiveStats:
    intra_bytes: float = 0.0     # wire bytes a rank inside a node (NVLink)
    cross_bytes: float = 0.0     # wire bytes a rank between nodes (network)
    counts: dict = dataclasses.field(default_factory=dict)

    def add(self, kind, intra, cross):
        self.intra_bytes += intra
        self.cross_bytes += cross
        self.counts[kind] = self.counts.get(kind, 0) + 1


def collective_stats(inventory, *, num_devices: int,
                     devices_per_pod: int) -> CollectiveStats:
    """Wire bytes a rank of the collectives in ``inventory``
    (``analysis.collective_check.Collective`` entries, or a recording
    world's raw log converted by ``collective_check.inventory``): an
    all-gather moves ``(n - 1) / n`` of its gathered result, an
    all-reduce twice ``(n - 1) / n`` of its buffer (ring), an all-to-all
    ``(n - 1) / n`` of its buffer, for a group of ``n`` ranks.  A group
    that spans more than one block of ``devices_per_pod`` consecutive
    ranks crosses nodes."""
    from repro_torch.analysis.collective_check import HLO_BYTES
    stats = CollectiveStats()
    for c in inventory:
        kind = _KIND.get(c.kind, c.kind)
        groups = c.groups or (tuple(range(num_devices)),)
        n = max(len(groups[0]), 1)
        nbytes = c.elements * HLO_BYTES[c.dtype]
        if kind == "all-gather":
            wire = nbytes * n * (n - 1) / n     # the result is n inputs
        elif kind == "all-reduce":
            wire = 2 * nbytes * (n - 1) / n
        else:
            wire = nbytes * (n - 1) / n
        crosses = any(len({r // devices_per_pod for r in g}) > 1
                      for g in groups)
        if crosses:
            stats.add(kind, 0.0, wire)
        else:
            stats.add(kind, wire, 0.0)
    return stats


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    intra_bytes_per_chip: float
    cross_bytes_per_chip: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float
    useful_ratio: float
    collective_counts: dict


def roofline(flops: float, hbm_bytes: float, stats: CollectiveStats, *,
             num_devices: int, model_flops: float = 0.0) -> Roofline:
    """Roofline terms of one rank's step on the H100 constants above."""
    t_comp = flops / PEAK_FLOPS
    t_mem = hbm_bytes / HBM_BW
    t_coll = stats.intra_bytes / NVLINK_BW + stats.cross_bytes / NET_BW
    dom = max(("compute", t_comp), ("memory", t_mem),
              ("collective", t_coll), key=lambda kv: kv[1])[0]
    useful = (model_flops / max(flops * num_devices, 1.0)
              if model_flops else 0.0)
    return Roofline(flops_per_chip=flops, hbm_bytes_per_chip=hbm_bytes,
                    intra_bytes_per_chip=stats.intra_bytes,
                    cross_bytes_per_chip=stats.cross_bytes,
                    t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
                    dominant=dom, model_flops=model_flops,
                    useful_ratio=useful, collective_counts=stats.counts)


def model_flops_estimate(arch, seq_len: int, global_batch: int,
                         kind: str, n_params_active: float) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd) with N = active params."""
    tokens = (global_batch * seq_len if kind in ("train", "prefill")
              else global_batch)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts, for every ATen op run under it: ``flops`` by
    ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention), ``hbm_bytes`` as the bytes of its tensor inputs plus its
    tensor outputs (view ops and uninitialized allocations count none),
    and ``ops``.  Works on meta tensors."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        formula = self._formulas.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        if not func.is_view and packet not in _NO_TRAFFIC:
            moved = 0
            for a in _tensors((args, kwargs)):
                moved += _nbytes(a)
            for o in _tensors(out):
                moved += _nbytes(o)
            self.hbm_bytes += moved
        return out


_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.detach,
               torch.ops.aten.lift_fresh}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested dict/list) tree."""
    return sum(_nbytes(t) for t in _tensors(tree))


def state_bytes(params, opt_state) -> dict:
    """Bytes of a training state by part: the parameters, their
    gradients (``.grad``) and the optimizer state (AdamW's two f32
    moments)."""
    leaves = list(_tensors(params))
    return {"params": sum(_nbytes(p) for p in leaves),
            "grads": sum(_nbytes(p.grad) for p in leaves
                         if p.grad is not None),
            "opt": tree_bytes(opt_state)}


class SavedBytes:
    """``torch.autograd.graph.saved_tensors_hooks`` that sum the bytes of
    the tensors autograd keeps for the backward, the parameters (and
    views of them) excepted: those are counted once among the
    arguments.  ``on_backward`` is called once, at the first unpack: the
    backward's start."""

    def __init__(self, params=(), on_backward=None):
        self.skip = {id(p) for p in params}
        self.bytes = 0
        self._on_backward = on_backward

    def _pack(self, t):
        base = t._base if t._base is not None else t
        if id(t) not in self.skip and id(base) not in self.skip:
            self.bytes += _nbytes(t)
        return t

    def _unpack(self, t):
        if self._on_backward is not None:
            self._on_backward()
            self._on_backward = None
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)
