"""Step-health checks: the non-finite reduce over loss and gradients, and
the host-side detectors (EMA loss spike, dropped-token watermark) the
recovery policy consumes (the counterpart of
``repro/resilience/guards.py``).

The guarded train step does not call :func:`nonfinite_score`: its verdict
reuses the clip's global gradient norm, which is non-finite exactly when
some gradient element is.  The function spells the same test out for one
tree.
"""

from __future__ import annotations

import math

import torch


def nonfinite_score(loss, grads) -> torch.Tensor:
    """A float32 scalar that is finite exactly when ``loss`` and every
    tensor of ``grads`` (a nested dict/list tree) are: ``sum(g * 0)`` is
    0.0 for a finite leaf and NaN when any element is NaN or inf."""
    from repro_torch.optim.adamw import tree_leaves
    z = (torch.as_tensor(loss) * 0.0).to(torch.float32)
    for g in tree_leaves(grads):
        z = z + torch.sum(g * 0).to(torch.float32)
    return z


class SpikeDetector:
    """EMA loss-spike detector: sustained ``loss > factor * ema`` trips it.

    The EMA only absorbs *non-spiking* finite losses (a spike must not
    poison its own baseline), and the first ``warmup`` updates never trip.
    ``update`` returns True when ``patience`` consecutive spiking steps have
    been seen; ``reset`` (after a rollback) clears the streak but keeps the
    healthy EMA.
    """

    def __init__(self, factor: float = 3.0, patience: int = 2,
                 beta: float = 0.9, warmup: int = 5):
        self.factor = factor
        self.patience = patience
        self.beta = beta
        self.warmup = warmup
        self.ema = None
        self.n = 0
        self.streak = 0

    def update(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return False            # the non-finite guard owns this case
        if self.ema is None:
            self.ema = loss
        if self.n >= self.warmup and loss > self.factor * self.ema:
            self.streak += 1
        else:
            self.streak = 0
            self.ema = self.beta * self.ema + (1 - self.beta) * loss
        self.n += 1
        return self.streak >= self.patience

    def reset(self) -> None:
        self.streak = 0


class DropWatermark:
    """Sustained-breach watermark on the dispatch ``dropped`` metric (the
    share of routed assignments the capacities discarded).  ``update``
    returns True once ``patience`` consecutive observations exceed
    ``watermark``; ``watermark >= 1.0`` disables the check."""

    def __init__(self, watermark: float = 1.0, patience: int = 3):
        self.watermark = watermark
        self.patience = patience
        self.streak = 0

    def update(self, dropped: float | None) -> bool:
        if dropped is None or self.watermark >= 1.0:
            return False
        if dropped > self.watermark:
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.patience:
            self.streak = 0         # re-arm: one alarm per sustained breach
            return True
        return False
