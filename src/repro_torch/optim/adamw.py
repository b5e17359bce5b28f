"""AdamW with decoupled weight decay, global-norm clipping, and a
linear-warmup + cosine-decay schedule (the counterpart of
``repro/optim/adamw.py``, one for one).

Parameters, gradients and moments are nested dicts/lists of tensors; the
moments are float32 beside parameters of any dtype.  The update runs in
place (parameters and moments are overwritten under ``torch.no_grad``),
which at full width saves a second copy of the 3.3 B parameters and their
moments.  On an EP world the gradient norm spans the ranks' expert shards,
so the trainer computes it and passes it in (``grad_norm=``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/list tree, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_state(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: int, device="cpu") -> torch.Tensor:
    """Learning rate at ``step`` (float32, like the reference's)."""
    step = _f32(step, device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (cfg.min_lr_ratio
                                       + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, *,
                  grad_norm: torch.Tensor | None = None):
    """Updates ``params`` and ``state`` in place.  Returns ``(params,
    state, metrics)``; ``grad_norm`` (default: :func:`global_norm` of
    ``grads``) is the norm the clip divides by."""
    flat_p = tree_leaves(params)
    dev = flat_p[0].device
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step, dev)
    c1 = 1 - cfg.b1 ** _f32(step, dev)
    c2 = 1 - cfg.b2 ** _f32(step, dev)
    for p, g, mu, nu in zip(flat_p, tree_leaves(grads),
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        g = g.to(torch.float32) * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if p.dim() >= 2:                 # decay matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
