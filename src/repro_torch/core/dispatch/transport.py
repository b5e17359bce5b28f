"""Transport stage: how bytes move between EP ranks (the counterpart of
``repro/core/dispatch/transport.py``).

* :class:`A2ATransport` — equal-split staged all-to-all driven by the
  :class:`Stage` list of a dispatch plan.  Stage ``s`` delivers over the
  innermost ``s + 1`` EP axes as a chain of all-to-alls (outermost hop
  first) through the EP world's per-axis process groups
  (``launch.mesh.EPWorld.all_to_all``).  ``dist.all_to_all_single`` has no
  autograd, so dispatch and combine are ``torch.autograd.Function``\\ s
  whose backward is the other's chain: the combine chain is the exact
  transpose of the dispatch chain.  The wire codec (``wire.py``) is raw,
  a cast (cast before the chain, back after it) or scaled: encode once,
  move the payload and its ``[*sizes, E_l]`` f32 scales through the same
  chain, decode after the final transpose; its backward moves
  full-precision cotangents (straight-through).
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


def _hops(t, stage: Stage, exchange, reverse: bool = False):
    """``exchange`` over each axis of the chain on dim ``i`` of a
    ``[*sizes, ...]`` tensor: outermost hop first, or innermost first for
    the reverse chain."""
    k = len(stage.axis_names)
    for i in (range(k - 1, -1, -1) if reverse else range(k)):
        t = exchange(t, stage.axis_names[i], i)
    return t


def dispatch_chain(buf, stage: Stage, exchange):
    """[*sizes, E_l, C, d] -> ``exchange`` over each axis of the chain
    (outermost hop first) -> [E_l, num_dests * C, d].  ``exchange(x, axis,
    dim)`` is the EP world's tiled all-to-all."""
    k = len(stage.axis_names)
    buf = _hops(buf, stage, exchange)
    E_l, C, d = buf.shape[k:]
    perm = (k,) + tuple(range(k)) + (k + 1, k + 2)
    return buf.permute(perm).reshape(E_l, stage.num_dests * C, d)


def counts_chain(cnt, stage: Stage, exchange):
    """[*sizes, E_l] per-(destination, expert) values (valid-row counts,
    wire scales) -> ``exchange`` over each axis of the chain -> [E_l,
    num_dests] per-(expert, source) values at the receiver: the chain and
    transpose of :func:`dispatch_chain` without the row axes."""
    k = len(stage.axis_names)
    cnt = _hops(cnt, stage, exchange)
    return cnt.permute((k,) + tuple(range(k))).reshape(cnt.shape[k],
                                                       stage.num_dests)


def _send_layout(y, stage: Stage):
    """[E_l, num_dests * C, d] -> [*sizes, E_l, C, d]."""
    sizes = stage.axis_sizes
    k = len(sizes)
    E_l, R, d = y.shape
    y = y.reshape((E_l,) + tuple(sizes) + (R // stage.num_dests, d))
    return y.permute(tuple(range(1, k + 1)) + (0, k + 1, k + 2))


def combine_chain(y, stage: Stage, exchange):
    """Inverse (== transpose) of :func:`dispatch_chain`: [E_l,
    num_dests * C, d] -> reverse chain -> [*sizes, E_l, C, d]."""
    return _hops(_send_layout(y, stage), stage, exchange, reverse=True)


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


def _identity(t, axis, dim):
    return t


class _DispatchScaled(torch.autograd.Function):
    """Scaled-codec dispatch: encode the [*sizes, E_l, C, d] buffer once
    (one scale per [C, d] block), move the payload through the chain and
    the [*sizes, E_l] scales through the counts' chain, decode at the
    receiver.  ``round`` and the narrow cast have no gradient, and the
    forward is a permutation up to rounding, so the backward is the
    full-precision reverse chain (straight-through)."""

    @staticmethod
    def forward(ctx, buf, codec, stage, exchange):
        ctx.stage, ctx.exchange = stage, exchange
        payload, scale = codec.encode(buf, block_ndim=2)
        out = dispatch_chain(payload, stage, exchange)
        s = counts_chain(scale, stage, exchange)            # [E_l, dests]
        E_l, R, d = out.shape
        out = out.reshape(E_l, stage.num_dests, R // stage.num_dests, d)
        return codec.decode(out, s[:, :, None, None], buf.dtype).reshape(
            E_l, R, d)

    @staticmethod
    def backward(ctx, g):
        return combine_chain(g, ctx.stage, ctx.exchange).contiguous(), \
            None, None, None


class _CombineScaled(torch.autograd.Function):
    """Scaled-codec combine: transpose back to the send layout, encode,
    reverse chain for payload and scales, decode at the source;
    straight-through backward (the full-precision dispatch chain)."""

    @staticmethod
    def forward(ctx, y, codec, stage, exchange):
        ctx.stage, ctx.exchange = stage, exchange
        payload, scale = codec.encode(_send_layout(y, stage), block_ndim=2)
        payload = _hops(payload, stage, exchange, reverse=True)
        scale = _hops(scale, stage, exchange, reverse=True)
        return codec.decode(payload, scale[..., None, None], y.dtype)

    @staticmethod
    def backward(ctx, g):
        return dispatch_chain(g, ctx.stage, ctx.exchange).contiguous(), \
            None, None, None


@dataclasses.dataclass(frozen=True)
class A2ATransport:
    """Equal-split staged all-to-all over the EP world's axes.

    ``world`` is the ``launch.mesh.EPWorld`` of this rank; ``codec`` a
    ``wire`` codec (or None for the raw model-dtype wire).  A stage with
    one destination exchanges nothing: its chain is a plain reshape (the
    scaled codec still encodes and decodes, as the reference's does).
    """

    ep: EPSpec
    world: object
    codec: object = None

    def _chain(self, fn, scaled, x, stage, plain):
        if self.codec is not None and self.codec.scaled:
            exchange = (_identity if stage.num_dests == 1
                        else self.world.all_to_all)
            return scaled.apply(x, self.codec, stage, exchange)
        wire = x if self.codec is None else self.codec.encode(x)[0]
        if stage.num_dests == 1:
            out = plain(wire, stage, _identity)
        else:
            out = fn.apply(wire, stage, self.world.all_to_all)
        return out.to(x.dtype)

    def dispatch(self, buf, stage: Stage):
        """[*sizes, E_l, C, d] local buffer -> [E_l, num_dests * C, d]
        expert rows at the receiver."""
        return self._chain(_Dispatch, _DispatchScaled, buf, stage,
                           dispatch_chain)

    def combine(self, y, stage: Stage):
        """[E_l, num_dests * C, d] expert outputs -> [*sizes, E_l, C, d]
        back at the source (reverse chain, innermost hop first)."""
        return self._chain(_Combine, _CombineScaled, y, stage, combine_chain)

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
