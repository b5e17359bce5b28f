"""Resilient training runtime: chaos fault injection, step-health guards,
and the recovery policy (skip / rollback / degraded-topology replan); the
counterpart of ``repro/resilience``."""

from repro_torch.resilience.chaos import ChaosConfig
from repro_torch.resilience.policy import RecoveryPolicy, ResilienceConfig

__all__ = ["ChaosConfig", "RecoveryPolicy", "ResilienceConfig"]
