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
* :class:`GatherTransport` — the weights-stationary decode regime: the
  tokens are all-gathered over the EP axes (one collective, in the
  mixed-radix EP rank order), every rank runs its
  expert shard on all of them, the partial outputs are summed over the
  EP axes and each rank keeps its own rows.  Gather and sum are
  ``torch.autograd.Function``\\ s: the gather's backward sums the
  cotangents over the axis and keeps this rank's rows, the sum's
  backward is the same sum.

The deprecated surfaces survive as in the reference: ``wire_a2a``'s and
``A2ATransport``'s ``wire_dtype=`` (the cast-only codec, with a
``DeprecationWarning``) and the 2-level ``dispatch_near`` /
``dispatch_far`` / ``combine_near`` / ``combine_far`` (stage 0 and 1).

Buffer layout contract with the moe_permute dispatch: the payload arrives
(stage, destination, expert, slot)-sorted, so each stage's delivered rows
are contiguous per-expert spans (:func:`expert_segments`,
:func:`stage_segments`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dispatch import wire
from repro_torch.core.dispatch.base import EPSpec


def _tiled_a2a(x, world, axis_name, split_axis: int, concat_axis: int):
    """JAX's tiled ``all_to_all(split_axis, concat_axis)`` over
    ``axis_name`` of the EP world: ``split_axis`` cut into one slice a
    member, slice ``j`` sent to member ``j``, the received slices
    concatenated on ``concat_axis`` in member order."""
    n = world.shape[axis_name]
    if n == 1:
        return x
    s, c = split_axis % x.dim(), concat_axis % x.dim()
    shape = tuple(x.shape)
    parts = x.reshape(shape[:s] + (n, shape[s] // n) + shape[s + 1:])
    got = world.all_to_all(parts.movedim(s, 0).contiguous(), axis_name, 0)
    return torch.cat(got.unbind(0), dim=c)


class _WireA2A(torch.autograd.Function):
    """The tiled all-to-all; backward: the same exchange with split and
    concat swapped (its transpose)."""

    @staticmethod
    def forward(ctx, x, world, axis_name, split_axis, concat_axis):
        ctx.args = (world, axis_name, concat_axis, split_axis)
        return _tiled_a2a(x, world, axis_name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _tiled_a2a(g.contiguous(), *ctx.args), None, None, None, None


def wire_a2a(x, world, axis_name, *, split_axis, concat_axis,
             wire_dtype: str = ""):
    """all_to_all over ``axis_name`` of ``world`` (the EP world) with an
    optional (deprecated) on-the-wire dtype cast.

    ``wire_dtype=`` resolves to the cast-only codec with a
    DeprecationWarning; scaled codecs need the segment layout only
    :class:`A2ATransport` knows, so quantized wire goes through a
    transport built with ``codec=`` instead of this helper."""
    codec = wire.resolve(None, wire_dtype)
    if codec is not None:
        payload, _ = codec.encode(x)
        payload = _WireA2A.apply(payload, world, axis_name, split_axis,
                                 concat_axis)
        return codec.decode(payload, None, x.dtype)
    return _WireA2A.apply(x, world, axis_name, split_axis, concat_axis)


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
    ``wire`` codec, a registered name, or None for the raw model-dtype
    wire; ``wire_dtype`` the deprecated stringly alias, resolved to the
    byte-identical cast codec with a DeprecationWarning.  A stage with
    one destination exchanges nothing: its chain is a plain reshape (the
    scaled codec still encodes and decodes, as the reference's does).
    """

    ep: EPSpec
    world: object
    codec: object = None
    wire_dtype: str = ""          # deprecated: use codec=

    def __post_init__(self):
        object.__setattr__(self, "codec",
                           wire.resolve(self.codec, self.wire_dtype,
                                        stacklevel=4))

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

    # --- deprecated near/far wrappers (the reference's 2-level surface) ---

    def _stage2(self, index: int) -> Stage:
        names, sizes = self.ep.axis_names, self.ep.axis_sizes
        n = len(names)
        return Stage(index=index, axis_names=names[n - index - 1:],
                     axis_sizes=sizes[n - index - 1:], cap=0)

    def dispatch_near(self, buf):
        """Deprecated: ``dispatch(buf, stage 0)``."""
        return self.dispatch(buf, self._stage2(0))

    def dispatch_far(self, buf):
        """Deprecated: ``dispatch(buf, stage 1)``."""
        return self.dispatch(buf, self._stage2(1))

    def combine_near(self, y):
        """Deprecated: ``combine(y, stage 0)``."""
        return self.combine(y, self._stage2(0))

    def combine_far(self, y):
        """Deprecated: ``combine(y, stage 1)``."""
        return self.combine(y, self._stage2(1))


class _AllGather(torch.autograd.Function):
    """Tiled all-gather over ``axes``; backward: the sum of the cotangents
    over the axes, this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, world, axes):
        ctx.world, ctx.axes, ctx.rows = world, axes, x.shape[0]
        return world.all_gather(x, axes)

    @staticmethod
    def backward(ctx, g):
        g = ctx.world.all_reduce_sum(g.contiguous(), ctx.axes)
        i = 0
        for c, a in zip(ctx.world.coords_of(ctx.axes), ctx.axes):
            i = i * ctx.world.shape[a] + c
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


class _AllReduce(torch.autograd.Function):
    """Sum over ``axes``; its own transpose."""

    @staticmethod
    def forward(ctx, y, world, axes):
        ctx.world, ctx.axes = world, axes
        return world.all_reduce_sum(y, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.world.all_reduce_sum(g.contiguous(), ctx.axes), None, None


@dataclasses.dataclass(frozen=True)
class GatherTransport:
    """Weights-stationary transport: gather tokens, sum partial outputs.
    ``world`` is the ``launch.mesh.EPWorld`` of this rank (None: one
    rank, where gather, sum and slice are identities)."""

    ep: EPSpec
    world: object = None
    tokens_replicated: bool = False   # tokens already on every EP rank

    def _spans_ranks(self) -> bool:
        return self.world is not None and self.ep.ep_world > 1

    def gather(self, x):
        """[T_local, d] -> [T_global, d] on every EP rank, in one
        all-gather over the EP axes: the global order is outermost-major
        EP rank order, as the reference's innermost-first gathers give."""
        if self.tokens_replicated or not self._spans_ranks():
            return x
        return _AllGather.apply(x, self.world, tuple(self.ep.axis_names))

    def reduce(self, y):
        """Sum of the EP ranks' partial expert outputs (one all-reduce
        over the EP axes)."""
        if not self._spans_ranks():
            return y
        return _AllReduce.apply(y, self.world, tuple(self.ep.axis_names))

    def slice_local(self, y, my_rank: int, T: int):
        """[T_global, d] -> this rank's [T_local, d] rows (all of them when
        the tokens were replicated)."""
        if self.tokens_replicated or not self._spans_ranks():
            return y
        return y[my_rank * T:(my_rank + 1) * T]
