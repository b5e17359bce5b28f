"""Recovery policy: turns guard verdicts into actions (the counterpart of
``repro/resilience/policy.py``, same state machine, counters and
precedence).

    healthy --non-finite loss/grads--> SKIP      (the update is not applied)
    healthy --sustained EMA spike----> ROLLBACK  (restore the newest rolling
                                                  checkpoint that passes its
                                                  sha256 manifest)
    healthy --link slowdown >= thr---> REPLAN    (re-solve the Eq. (7)
                                                  DispatchPlan with the
                                                  degraded level's ratio
                                                  shrunk or collapsed, and
                                                  rebuild the step at the
                                                  boundary)

Replans happen only at ``replan_every`` boundaries, as in the reference,
where the plan is static per compilation.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.resilience import chaos as chaos_lib
from repro_torch.resilience import guards


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Guard and recovery knobs; attach to ``RunConfig.resilience``.

    With no chaos config and no fault firing, the guarded loop trains the
    unguarded loop's parameters bit for bit (fault multipliers of 1.0 are
    exact, and the verdict only reads the loss and the clip's norm)."""

    # skip the update on non-finite loss/grads
    skip_nonfinite: bool = True
    # rollback to the last good rolling checkpoint on sustained loss spike
    rollback_on_spike: bool = False
    spike_factor: float = 3.0
    spike_patience: int = 2
    spike_ema_beta: float = 0.9
    spike_warmup: int = 5
    # dropped-token watermark off the engine's `dropped` metric
    drop_watermark: float = 1.0       # >= 1.0 disables
    drop_patience: int = 3
    # degraded-topology fallback: probe links every `replan_every` steps
    # (0 disables); a level whose observed beta slowdown against the first
    # probe reaches `degrade_threshold` gets its Eq. (7) ratio shrunk by
    # that slowdown, and `collapse_slowdown` collapses it to 0 (local-only
    # dispatch, the empty-level rule of capacity.stage_ratio)
    replan_every: int = 0
    degrade_threshold: float = 4.0
    collapse_slowdown: float = 64.0
    # fault injection schedule (None = no chaos)
    chaos: chaos_lib.ChaosConfig | None = None


class RecoveryPolicy:
    """Host-side recovery policy owned by one training run.  Counters
    (``skipped_steps`` / ``rollbacks`` / ``replans`` / ``drop_alarms``)
    surface in ``TrainResult`` and every logged ``metrics_history``
    entry."""

    def __init__(self, cfg: ResilienceConfig):
        self.cfg = cfg
        self.spike = guards.SpikeDetector(
            factor=cfg.spike_factor, patience=cfg.spike_patience,
            beta=cfg.spike_ema_beta, warmup=cfg.spike_warmup)
        self.drop = guards.DropWatermark(
            watermark=cfg.drop_watermark, patience=cfg.drop_patience)
        self.skipped_steps = 0
        self.rollbacks = 0
        self.replans = 0
        self.drop_alarms = 0
        self._baseline_links: dict | None = None
        self._applied_scales: dict = {}

    @property
    def healthy(self) -> bool:
        """No suspicion in flight: safe to take a rolling checkpoint (one
        written mid-spike would poison the rollback target)."""
        return self.spike.streak == 0

    def counters(self) -> dict:
        return {"skipped_steps": self.skipped_steps,
                "rollbacks": self.rollbacks, "replans": self.replans,
                "drop_alarms": self.drop_alarms}

    # -- per-step classification --------------------------------------------

    def classify(self, step: int, metrics: dict) -> str:
        """Map one step's host-visible metrics (host floats) to "ok" |
        "skip" | "rollback"."""
        nonfinite = metrics.get("nonfinite", 0.0)
        loss = metrics.get("loss", float("nan"))
        if self.drop.update(metrics.get("dropped")):
            self.drop_alarms += 1
        if self.cfg.skip_nonfinite and (nonfinite > 0.0
                                        or not math.isfinite(loss)):
            self.skipped_steps += 1
            return "skip"
        if self.spike.update(loss) and self.cfg.rollback_on_spike:
            self.rollbacks += 1
            return "rollback"
        return "ok"

    def on_rollback(self) -> None:
        """Reset detectors after the state was restored (the EMA's healthy
        baseline is kept; only the spike streak clears)."""
        self.spike.reset()

    # -- degraded-topology fallback -----------------------------------------

    def observe_links(self, world, axis_names, step: int) -> dict:
        """Measured per-axis links of the EP world (with the chaos
        degradation applied) as slowdown ratios against the first probe.
        The first call pins the baseline from the unscaled measurement, so
        a degradation already active at the first probe is still caught.
        A collective: every rank calls it at the same step."""
        from repro_torch.core import comm_model
        links = comm_model.measured_ep_links(world, axis_names)
        if self._baseline_links is None:
            self._baseline_links = links
        mults = chaos_lib.link_multipliers(self.cfg.chaos, step)
        if mults:
            links = comm_model.scale_links(links, mults)
        return comm_model.link_slowdowns(links, self._baseline_links)

    def replan(self, ctx, slowdowns: dict):
        """Re-solve the dispatch plan against observed link slowdowns.

        Returns a replacement ``ModelCtx`` (the caller rebuilds its step)
        or None when nothing crossed ``degrade_threshold`` or the
        degradation set is unchanged since the last replan.  Axis ``k`` of
        the EP hierarchy (outermost first) feeds topology level ``n - k``;
        a slowdown past ``collapse_slowdown`` scales that level's inverse
        bandwidth to inf, which drives its Eq. (7) ratio to exactly 0."""
        if ctx.plan is None or ctx.ep is None:
            return None
        names = tuple(ctx.ep.axis_names)
        n = len(names)
        scales = {}
        for k, ax in enumerate(names):
            s = slowdowns.get(ax, 1.0)
            if s >= self.cfg.collapse_slowdown:
                scales[n - k] = math.inf
            elif s >= self.cfg.degrade_threshold:
                scales[n - k] = float(s)
        if scales == self._applied_scales:
            return None
        from repro_torch.core import capacity, topology
        from repro_torch.models import model as model_lib
        level_scale = tuple(scales.get(level, 1.0) for level in range(n + 1))
        plan = ctx.plan
        new_plan = capacity.make_dispatch_plan(
            tokens_per_device=plan.tokens_per_device,
            num_experts=plan.num_experts,
            top_k=ctx.arch.moe.top_k,
            capacity_factor=ctx.arch.moe.capacity_factor,
            axis_sizes=plan.axis_sizes, axis_names=names, mode=plan.mode,
            comm=topology.tree_topology_nd(plan.axis_sizes),
            level_beta_scale=level_scale)
        if plan.num_chunks > 1:
            new_plan = capacity.align_to_chunks(new_plan, plan.num_chunks)
        if new_plan.caps == plan.caps:
            self._applied_scales = scales
            return None
        gate_cfg = model_lib.make_gate_cfg(ctx.arch, new_plan, ctx.ep,
                                           ctx.gate_cfg.aux_mode)
        self._applied_scales = scales
        self.replans += 1
        return dataclasses.replace(ctx, plan=new_plan, gate_cfg=gate_cfg)
