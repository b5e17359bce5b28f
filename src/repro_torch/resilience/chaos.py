"""Deterministic, seeded fault injection for resilience testing (the
counterpart of ``repro/resilience/chaos.py``, numpy and host code only).

Every fault family the runtime claims to survive is a reproducible
scenario here, not a prayer: faults fire at explicit step indices, byte
corruption is seeded, and link degradation is a pure function of
``(config, step)`` — so a chaos run is exactly as replayable as a clean
one.

Fault families and where they land:

* non-finite grads / activations — ``fault_scales`` produces per-step
  ``loss_mult`` / ``grad_mult`` scalars the guarded train step multiplies
  into the differentiated loss.  ``loss_mult``
  poisons the *differentiated* total upstream of backprop (an
  activation-level fault: every grad goes non-finite); ``grad_mult``
  poisons or scales the grads directly.
* degraded links — ``link_multipliers`` yields per-mesh-axis beta
  multipliers applied on top of ``comm_model.measured_ep_links`` (via
  ``comm_model.scale_links``); a degradation persists from its step on.
* stragglers — ``maybe_straggle`` injects a host-side delay before the
  step, modelling a slow rank.
* checkpoint corruption — ``corrupt_checkpoint`` flips seeded bytes in a
  saved payload so the sha256 manifest check fails.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One reproducible fault schedule.  All step fields are tuples of
    global step indices; an empty tuple disables that family."""

    seed: int = 0
    # non-finite grad fault: grads multiplied by nan at these steps
    nan_grad_steps: tuple = ()
    # non-finite activation fault: the differentiated loss multiplied by
    # nan (backprop poisons every grad)
    nan_loss_steps: tuple = ()
    # loss-spike fault: the updated params scaled by `spike_scale` at
    # these steps (a sick-rank / divergence model — the *subsequent*
    # losses spike because the params got wrecked; injecting into grads
    # would be silently neutralized by global-norm clipping, and mild
    # scales are absorbed by RMSNorm's scale invariance — 10x is enough
    # to saturate attention scores and the unembed logits)
    spike_steps: tuple = ()
    spike_scale: float = 10.0
    # degraded links: (step, axis_name, beta_multiplier) triples; the
    # multiplier applies to every link observation from `step` onward
    degraded_links: tuple = ()
    # stragglers: host-side delay injected before these steps
    straggler_steps: tuple = ()
    straggler_delay_s: float = 0.02
    # checkpoint corruption: rolling checkpoints saved at these steps get
    # seeded byte flips right after the save
    corrupt_ckpt_steps: tuple = ()

    @property
    def any_step_faults(self) -> bool:
        return bool(self.nan_grad_steps or self.nan_loss_steps
                    or self.spike_steps)


def fault_scales(cfg: ChaosConfig | None, step: int) -> dict:
    """Per-step ``{"loss_mult", "grad_mult", "param_scale"}`` floats
    (all 1.0 when no fault fires — the healthy fast path; multiplying by
    exactly 1.0 is bitwise-exact).  The two mults feed the guarded train
    step; ``param_scale`` is applied by the host loop between steps so the
    healthy path never pays for it."""
    loss_mult, grad_mult, param_scale = 1.0, 1.0, 1.0
    if cfg is not None:
        if step in cfg.nan_loss_steps:
            loss_mult = float("nan")
        if step in cfg.nan_grad_steps:
            grad_mult = float("nan")
        if step in cfg.spike_steps:
            param_scale = cfg.spike_scale
    return {"loss_mult": loss_mult, "grad_mult": grad_mult,
            "param_scale": param_scale}


def link_multipliers(cfg: ChaosConfig | None, step: int) -> dict:
    """Accumulated per-axis beta multipliers active at ``step`` (every
    ``degraded_links`` entry whose step has passed compounds in)."""
    mults: dict = {}
    if cfg is not None:
        for at, axis, mult in cfg.degraded_links:
            if step >= at:
                mults[axis] = mults.get(axis, 1.0) * float(mult)
    return mults


def maybe_straggle(cfg: ChaosConfig | None, step: int) -> bool:
    """Host-side straggler delay before ``step``; returns True if slept."""
    if cfg is not None and step in cfg.straggler_steps:
        time.sleep(cfg.straggler_delay_s)
        return True
    return False


def should_corrupt(cfg: ChaosConfig | None, step: int) -> bool:
    return cfg is not None and step in cfg.corrupt_ckpt_steps


def corrupt_checkpoint(path: str, seed: int = 0, nbytes: int = 64) -> None:
    """Flip ``nbytes`` seeded bytes in the payload at ``path``.

    Deterministic per (path size, seed).  The flips land in the interior
    of the file, so the archive may or may not still load — either way
    the sha256 manifest check (``ckpt.verify`` / ``ckpt.restore``) fails,
    which is the contract the rollback fallback relies on.
    """
    size = os.path.getsize(path)
    if size < 2:
        return
    rng = np.random.default_rng(seed)
    offsets = rng.integers(low=size // 4, high=max(size // 4 + 1, size - 1),
                           size=min(nbytes, size // 2))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(int(off))
            b = f.read(1)
            f.seek(int(off))
            f.write(bytes([b[0] ^ 0xFF]))
