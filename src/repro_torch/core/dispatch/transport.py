"""Transport stage: how bytes move between EP ranks (the counterpart of
``repro/core/dispatch/transport.py``).

* :class:`A2ATransport` — equal-split staged all-to-all driven by the
  :class:`Stage` list of a dispatch plan.  Stage ``s`` delivers over the
  innermost ``s + 1`` EP axes as a chain of all-to-alls (outermost hop
  first) through the EP world's per-axis process groups
  (``launch.mesh.EPWorld.all_to_all``).  ``dist.all_to_all_single`` has no
  autograd, so dispatch and combine are ``torch.autograd.Function``\\ s
  whose backward is the other's chain: the combine chain is the exact
  transpose of the dispatch chain.  The wire codec is raw or the ``bf16``
  cast: the payload is cast before the chain and back after it.
* :class:`GatherTransport` — the weights-stationary decode regime, on one
  rank only in this port (gather, reduce and slice are identities).

Buffer layout contract with the moe_permute dispatch: the payload arrives
(stage, destination, expert, slot)-sorted, so each stage's delivered rows
are contiguous per-expert spans (:func:`expert_segments`,
:func:`stage_segments`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dispatch.base import EPSpec


@dataclasses.dataclass(frozen=True)
class Stage:
    """One level-indexed exchange stage of a dispatch plan: the delivery
    chain ``axis_names`` / ``axis_sizes`` (outermost hop first) and the
    per-(source, expert) capacity ``cap``."""

    index: int                    # dispatch stage (0 = innermost)
    axis_names: tuple
    axis_sizes: tuple
    cap: int

    @property
    def num_dests(self) -> int:
        """Destination ranks addressed by this stage's buffer (incl. the
        lower-stage block that routing masks out)."""
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def plan_stages(plan, ep: EPSpec) -> tuple:
    """Active :class:`Stage` list for one plan on one EP spec."""
    names, sizes = ep.axis_names, ep.axis_sizes
    n = len(names)
    if plan.num_stages != n:
        raise ValueError(f"plan has {plan.num_stages} stages but the EP spec "
                         f"spans {n} axes {names}; rebuild the plan")
    return tuple(Stage(index=s, axis_names=names[n - s - 1:],
                       axis_sizes=sizes[n - s - 1:], cap=plan.caps[s])
                 for s in range(n) if plan.caps[s] > 0)


def expert_segments(num_experts: int, rows_per_expert: int) -> tuple:
    """Static [E + 1] segment offsets: expert ``e`` owns flat rows
    ``offs[e]:offs[e + 1]`` of the [E * rows, d] view."""
    return tuple(rows_per_expert * e for e in range(num_experts + 1))


def stage_segments(num_experts: int, stage_widths) -> tuple:
    """Fine ``(seg_offsets, seg_experts)`` of a delivered buffer
    concatenated over stages: flat row order is (expert, stage,
    destination, capacity-slot) and ``stage_widths`` is the static
    ``((num_dests, rows_per_dest), ...)`` stage list.  One segment per
    (expert, stage, source): the granularity at which delivered rows are a
    valid prefix."""
    offs, exps = [0], []
    for e in range(num_experts):
        for num_dests, width in stage_widths:
            for _ in range(num_dests):
                offs.append(offs[-1] + width)
                exps.append(e)
    return tuple(offs), tuple(exps)


def dispatch_chain(buf, stage: Stage, exchange):
    """[*sizes, E_l, C, d] -> ``exchange`` over each axis of the chain
    (outermost hop first) -> [E_l, num_dests * C, d].  ``exchange(x, axis,
    dim)`` is the EP world's tiled all-to-all."""
    k = len(stage.axis_names)
    for i in range(k):
        buf = exchange(buf, stage.axis_names[i], i)
    E_l, C, d = buf.shape[k:]
    perm = (k,) + tuple(range(k)) + (k + 1, k + 2)
    return buf.permute(perm).reshape(E_l, stage.num_dests * C, d)


def counts_chain(cnt, stage: Stage, exchange):
    """[*sizes, E_l] per-(destination, expert) valid-row counts ->
    ``exchange`` over each axis of the chain -> [E_l, num_dests]
    per-(expert, source) counts at the receiver: the chain and transpose of
    :func:`dispatch_chain` without the row axes."""
    k = len(stage.axis_names)
    for i in range(k):
        cnt = exchange(cnt, stage.axis_names[i], i)
    return cnt.permute((k,) + tuple(range(k))).reshape(cnt.shape[k],
                                                       stage.num_dests)


def combine_chain(y, stage: Stage, exchange):
    """Inverse (== transpose) of :func:`dispatch_chain`: [E_l,
    num_dests * C, d] -> reverse chain -> [*sizes, E_l, C, d]."""
    sizes = stage.axis_sizes
    k = len(sizes)
    E_l, R, d = y.shape
    y = y.reshape((E_l,) + tuple(sizes) + (R // stage.num_dests, d))
    y = y.permute(tuple(range(1, k + 1)) + (0, k + 1, k + 2))
    for i in range(k - 1, -1, -1):
        y = exchange(y, stage.axis_names[i], i)
    return y


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, stage, exchange):
        ctx.stage, ctx.exchange = stage, exchange
        return dispatch_chain(buf, stage, exchange).contiguous()

    @staticmethod
    def backward(ctx, g):
        return combine_chain(g, ctx.stage, ctx.exchange).contiguous(), \
            None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, stage, exchange):
        ctx.stage, ctx.exchange = stage, exchange
        return combine_chain(y, stage, exchange).contiguous()

    @staticmethod
    def backward(ctx, g):
        return dispatch_chain(g, ctx.stage, ctx.exchange).contiguous(), \
            None, None


@dataclasses.dataclass(frozen=True)
class A2ATransport:
    """Equal-split staged all-to-all over the EP world's axes.

    ``world`` is the ``launch.mesh.EPWorld`` of this rank; ``codec`` a
    cast codec of ``base`` (or None for the raw model-dtype wire).  A
    stage with one destination exchanges nothing: its chain is a plain
    reshape, differentiated by autograd.
    """

    ep: EPSpec
    world: object
    codec: object = None

    def _chain(self, fn, x, stage, plain):
        wire = x if self.codec is None else x.to(self.codec.dtype)
        if stage.num_dests == 1:
            out = plain(wire, stage, lambda t, axis, dim: t)
        else:
            out = fn.apply(wire, stage, self.world.all_to_all)
        return out.to(x.dtype)

    def dispatch(self, buf, stage: Stage):
        """[*sizes, E_l, C, d] local buffer -> [E_l, num_dests * C, d]
        expert rows at the receiver."""
        return self._chain(_Dispatch, buf, stage, dispatch_chain)

    def combine(self, y, stage: Stage):
        """[E_l, num_dests * C, d] expert outputs -> [*sizes, E_l, C, d]
        back at the source (reverse chain, innermost hop first)."""
        return self._chain(_Combine, y, stage, combine_chain)

    def dispatch_counts(self, cnt, stage: Stage):
        """[*sizes, E_l] per-(destination, expert) valid-row counts ->
        [E_l, num_dests] per-(expert, source) counts at the receiver, over
        the same chain and transpose as :meth:`dispatch`, exact (int32, no
        wire cast, no gradient)."""
        return counts_chain(cnt, stage, self.world.all_to_all)


@dataclasses.dataclass(frozen=True)
class GatherTransport:
    """Weights-stationary transport: gather tokens, sum partial outputs."""

    ep: EPSpec
    tokens_replicated: bool = False

    def __post_init__(self):
        if self.ep.ep_world != 1:
            raise NotImplementedError(
                f"the gather path over {self.ep.ep_world} ranks is not "
                f"ported yet (it runs on one rank)")

    def gather(self, x):
        """[T_local, d] -> [T_global, d]: the identity on one rank."""
        return x

    def reduce(self, y):
        """Sum of the ranks' partial expert outputs: the identity."""
        return y

    def slice_local(self, y, my_rank: int, T: int):
        """[T_global, d] -> this rank's [T_local, d] slice."""
        return y
