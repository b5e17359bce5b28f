"""Link-contention alpha-beta model of the global MoE exchange and the
overlap model that picks the pipelined path's chunk count (the
counterpart of ``repro/core/comm_model.py``; numpy only, the same float64
arithmetic, so both packages reach the same verdicts).

* :func:`simulate_exchange` — the paper's Eq. (2) lower bound and a
  per-link serialization estimate of one exchange (Table 1, Fig. 6a).
* :func:`moe_overlap_terms` / :func:`choose_num_chunks` — the exchange
  and compute times of one MoE layer and the chunk count minimizing the
  3-stage pipeline's predicted time.

The link constants (``topology``'s ICI/DCI ladder) and ``peak_flops``
are the reference's TPU figures, kept as the defaults because they decide
the chunk count and hence the capacities: the two packages must agree.
They are not this port's hardware.  Measured links (the reference's
``measure_link`` micro-benchmark) are not ported yet; a caller may pass
:class:`LinkEstimate` objects of its own through ``links=``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import topology as topo_lib
from repro_torch.core.capacity import a2a_bytes
from repro_torch.core.topology import CommModel


@dataclasses.dataclass(frozen=True)
class ExchangeTime:
    lower_bound: float
    contention: float
    per_level_bytes: dict  # level -> total bytes crossing that level


def simulate_exchange(model: CommModel, c_bytes: np.ndarray) -> ExchangeTime:
    """``c_bytes[i, j]``: bytes delivered from device i to device j.

    ``lower_bound`` is ``max_{i,j} (alpha_ij + beta_ij * bytes_ij)``;
    ``contention`` charges each device's send + receive bytes at each
    level against that level's bandwidth, takes the busiest (device,
    level) pair and adds the largest latency."""
    topo = model.topo
    P = topo.num_devices
    if c_bytes.shape != (P, P):
        raise ValueError(f"c_bytes {c_bytes.shape} is not [{P}, {P}]")
    lm = topo.level_matrix()
    alpha = np.asarray(model.alpha)[lm]
    beta = np.asarray(model.beta)[lm]

    lower = float((alpha + beta * c_bytes).max())

    busiest = 0.0
    per_level = {}
    for l in range(1, topo.num_levels):
        mask = lm == l
        per_level[l] = float(c_bytes[mask].sum())
        send = (c_bytes * mask).sum(axis=1)
        recv = (c_bytes * mask).sum(axis=0)
        t = (send + recv) * model.beta[l]
        busiest = max(busiest, float(t.max()))
    contention = busiest + float(np.asarray(model.alpha).max())
    return ExchangeTime(lower_bound=lower, contention=contention,
                        per_level_bytes=per_level)


def dispatch_matrix_from_ratios(model: CommModel, tokens_per_device: float,
                                d_bytes: float, mode: str = "even",
                                c_hat: np.ndarray | None = None
                                ) -> np.ndarray:
    """``c_bytes[i, j]`` for even dispatch or a supplied ``c_hat``."""
    P = model.topo.num_devices
    if mode == "even":
        c = np.full((P, P), tokens_per_device / P)
    elif c_hat is None:
        raise ValueError(f"mode {mode!r} needs c_hat")
    else:
        c = c_hat
    return c * d_bytes


# ---------------------------------------------------------------------------
# pipelined-dispatch overlap model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OverlapEstimate:
    """Predicted time of one MoE exchange + compute round."""

    num_chunks: int
    t_sync: float            # dispatch + GEMM + combine, serialized
    t_pipelined: float       # 3-stage software pipeline over num_chunks
    speedup: float

    @property
    def overlapped_fraction(self) -> float:
        """Share of the sync time the pipeline would hide."""
        return max(0.0, 1.0 - self.t_pipelined / max(self.t_sync, 1e-30))


def pipelined_time(t_dispatch: float, t_compute: float, t_combine: float,
                   num_chunks: int, alpha: float = 0.0) -> float:
    """Latency of the 3-stage pipeline: a chunk costs ``t / k + alpha`` per
    exchange (alpha is paid per collective), the pipeline fills in one
    pass of all three stages and drains at the slowest stage's rate."""
    k = max(1, int(num_chunks))
    d = t_dispatch / k + alpha
    g = t_compute / k
    c = t_combine / k + alpha
    return d + g + c + (k - 1) * max(d, g, c)


def estimate_overlap(*, t_exchange: float, t_compute: float,
                     alpha: float = 0.0,
                     num_chunks: int) -> OverlapEstimate:
    """Sync against pipelined time for one chunk count; the combine moves
    the dispatch's bytes back, so it costs ``t_exchange`` too."""
    t_sync = 2.0 * (t_exchange + alpha) + t_compute
    t_pipe = pipelined_time(t_exchange, t_compute, t_exchange,
                            num_chunks, alpha=alpha)
    return OverlapEstimate(num_chunks=int(num_chunks), t_sync=t_sync,
                           t_pipelined=t_pipe,
                           speedup=t_sync / max(t_pipe, 1e-30))


def choose_num_chunks(*, t_exchange: float, t_compute: float,
                      alpha: float = 0.0, candidates=(1, 2, 4, 8)) -> int:
    """The candidate chunk count with the least predicted pipelined time
    (the first such candidate on a tie)."""
    best = min(candidates,
               key=lambda k: pipelined_time(t_exchange, t_compute,
                                            t_exchange, k, alpha=alpha))
    return int(best)


def _stage_constants(plan, stage: int):
    """The reference's (alpha, beta) ladder for one dispatch stage:
    innermost ICI, outermost DCI, intermediate intra-pod DCN."""
    last = plan.num_stages - 1
    if stage == 0:
        return topo_lib.ICI_ALPHA, 1.0 / topo_lib.ICI_BW
    if stage == last:
        return topo_lib.DCI_ALPHA, 1.0 / topo_lib.DCI_BW
    return topo_lib.NODE_ALPHA, 1.0 / topo_lib.NODE_BW


def _stage_link(plan, stage: int, links: dict):
    """A given :class:`LinkEstimate` for one stage, keyed by the stage's
    outermost axis name or by ``"near"`` / ``"far"``; None if absent."""
    axis = plan.level_axes[stage][0] if stage < len(plan.level_axes) else None
    li = links.get(axis)
    if li is None:
        li = links.get("near" if stage == 0 else "far")
    return li


def stage_overlap_terms(plan, *, d_model: int, bytes_per_el: int,
                        links: dict | None = None, codec=None) -> list:
    """Per active dispatch stage: ``{stage, bytes, alpha, beta,
    t_exchange}``, the stage's send bytes (``capacity.a2a_bytes``, wire
    codec included) charged against its outermost hop's link."""
    links = links or {}
    b = a2a_bytes(plan, d_model, bytes_per_el, codec=codec)
    rows = []
    for s in range(plan.num_stages):
        if not plan.caps[s]:
            continue
        alpha_c, beta_c = _stage_constants(plan, s)
        li = _stage_link(plan, s, links)
        alpha = li.alpha if li else alpha_c
        beta = li.beta if li else beta_c
        rows.append({"stage": s, "bytes": b["by_level"][s],
                     "alpha": alpha, "beta": beta,
                     "t_exchange": b["by_level"][s] * beta})
    return rows


def moe_overlap_terms(plan, *, d_model: int, d_ff: int, bytes_per_el: int,
                      activation: str = "swiglu",
                      peak_flops: float = 197e12,
                      links: dict | None = None, codec=None) -> dict:
    """The overlap model's inputs from a dispatch plan: ``t_exchange``
    sums the stages' times (they share the device's link), ``t_compute``
    is the grouped expert FFN's FLOPs over ``peak_flops`` (every (source,
    expert, capacity slot) of every active stage's buffer is one row),
    and ``alpha`` is the slowest active stage's latency."""
    stages = stage_overlap_terms(plan, d_model=d_model,
                                 bytes_per_el=bytes_per_el, links=links,
                                 codec=codec)
    t_exchange = sum(r["t_exchange"] for r in stages)
    rows = sum(plan.caps[s] * plan.experts_per_rank * plan.stage_block(s)
               for s in range(plan.num_stages) if plan.caps[s])
    n_mats = 3 if activation == "swiglu" else 2
    flops = 2.0 * rows * d_model * d_ff * n_mats
    alpha = max((r["alpha"] for r in stages), default=0.0)
    return {"t_exchange": t_exchange, "t_compute": flops / peak_flops,
            "alpha": alpha}


# ---------------------------------------------------------------------------
# link estimates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkEstimate:
    """``t = alpha + beta * bytes`` for one axis."""

    alpha: float                  # s (per-collective latency)
    beta: float                   # s/byte (inverse bandwidth)
    nbytes: tuple = ()            # sampled per-device exchange sizes
    times: tuple = ()             # matching measured times (s)

    def predict(self, n: float) -> float:
        return self.alpha + self.beta * n


def scale_links(links: dict, multipliers: dict) -> dict:
    """Per-axis beta multipliers (``> 1``: a degraded link); axes without
    a multiplier and None links pass through.  Sampled times scale with
    beta."""
    out = {}
    for ax, li in links.items():
        m = float(multipliers.get(ax, 1.0))
        if li is None or m == 1.0:
            out[ax] = li
        else:
            out[ax] = dataclasses.replace(
                li, beta=li.beta * m, times=tuple(t * m for t in li.times))
    return out


def link_slowdowns(links: dict, baseline: dict) -> dict:
    """Per-axis beta ratio against a baseline (``> 1``: slower); axes
    missing from either side are skipped."""
    out = {}
    for ax, li in links.items():
        base = baseline.get(ax)
        if li is None or base is None:
            continue
        out[ax] = li.beta / max(base.beta, 1e-30)
    return out
