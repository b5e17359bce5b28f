"""MoE gate and auxiliary losses: load-balance (Eq. 1), TA-MoE topology
loss (Eq. 8), and the FasterMoE-style compulsory-ratio baseline — the
counterpart of ``repro/core/gating.py``.

Top-k follows ``jax.lax.top_k``'s order on ties (lowest index first):
a stable descending sort, not ``torch.topk``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class GateConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_mode: str = "lb"          # "lb" (Eq 1) | "ta" (Eq 8) | "hir" | "none"
    # normalized per-level penalties p (level 0=self, 1=intra-pod, ...)
    penalty_by_level: tuple = (1.0, 1.0, 1.0)
    hir_bias: float = 2.0
    router_dtype: torch.dtype = torch.float32


def init_gate_params(d_model: int, cfg: GateConfig, generator, device):
    scale = 1.0 / np.sqrt(d_model)
    return {"w": torch.randn((d_model, cfg.num_experts), generator=generator,
                             device=device, dtype=torch.float32) * scale}


def expert_levels_nd(num_experts: int, experts_per_rank: int, axis_sizes,
                     my_coords, device="cpu") -> torch.Tensor:
    """Topology level [N] of each global expert relative to this rank:
    0 = my own experts, ``n_axes - i`` when the owning rank first differs
    from mine at axis ``i``."""
    sizes = tuple(int(s) for s in axis_sizes)
    n = len(sizes)
    rank = torch.arange(num_experts, device=device) // experts_per_rank
    lvl = torch.zeros_like(rank)
    stride = 1
    for i in range(n - 1, -1, -1):
        c = (rank // stride) % sizes[i]
        lvl = torch.maximum(lvl, torch.where(
            c != int(my_coords[i]), n - i, 0))
        stride *= sizes[i]
    return lvl


def expert_levels(num_experts: int, experts_per_rank: int, ep_per_pod: int,
                  num_pods: int, my_pod, my_data, device="cpu") -> torch.Tensor:
    """Deprecated 2-level wrapper over :func:`expert_levels_nd`.

    Returns int [N]: 0 = my own experts, 1 = same pod, 2 = other pod."""
    if num_pods > 1:
        return expert_levels_nd(num_experts, experts_per_rank,
                                (num_pods, ep_per_pod), (my_pod, my_data),
                                device=device)
    return expert_levels_nd(num_experts, experts_per_rank, (ep_per_pod,),
                            (my_data,), device=device)


def topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` semantics: descending values, ties broken toward
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gate_forward(params, x, cfg: GateConfig, levels=None):
    """x: [T, d] -> dict of logits/probs [T, N], topk_idx/topk_weight
    [T, k] (renormalized combine weights)."""
    logits = x.to(cfg.router_dtype) @ params["w"].to(cfg.router_dtype)
    if cfg.aux_mode == "hir" and levels is not None:
        logits = logits + torch.where(levels <= 1, cfg.hir_bias, 0.0)
    probs = torch.softmax(logits, dim=-1)
    topk_weight, topk_idx = topk_stable(probs, cfg.top_k)
    if cfg.top_k > 1:
        topk_weight = topk_weight / (topk_weight.sum(-1, keepdim=True) + 1e-9)
    return {"logits": logits, "probs": probs,
            "topk_idx": topk_idx, "topk_weight": topk_weight}


def dispatch_fractions(topk_idx, num_experts: int) -> torch.Tensor:
    """c_e / (k*S): fraction of assignments routed to each expert. [N]"""
    counts = F.one_hot(topk_idx.long(), num_experts).to(
        torch.float32).sum(dim=(0, 1))
    return counts / (topk_idx.shape[0] * topk_idx.shape[1])


def frac_by_level(frac, levels, num_stages: int) -> torch.Tensor:
    """Per-stage dispatch fractions [num_stages]; stage ``s`` serves level
    ``s + 1`` and level 0 folds into stage 0."""
    stage = torch.clamp(levels - 1, 0, num_stages - 1)
    onehot = F.one_hot(stage.long(), num_stages).to(torch.float32)
    return torch.einsum("ns,n->s", onehot, frac.to(torch.float32))


def aux_loss(gate_out, cfg: GateConfig, levels=None) -> torch.Tensor:
    """lb (Eq. 1): N * sum_e m_e f_e; ta (Eq. 8): N * sum_e p_e m_e f_e;
    hir: as lb; none: 0."""
    probs = gate_out["probs"]
    if cfg.aux_mode == "none":
        return torch.zeros((), dtype=torch.float32, device=probs.device)
    m = probs.mean(dim=0)
    f = dispatch_fractions(gate_out["topk_idx"], cfg.num_experts)
    if cfg.aux_mode == "ta":
        if levels is None:
            raise ValueError("ta aux loss needs expert levels")
        pen = torch.as_tensor(cfg.penalty_by_level, dtype=torch.float32,
                              device=probs.device)[levels]
        return cfg.num_experts * torch.sum(pen * m * f)
    return cfg.num_experts * torch.sum(m * f)


def ta_penalties(ratios: tuple, norm: str = "sum",
                 level_sizes: tuple | None = None) -> tuple:
    """Per-level penalty weights p_l = Norm(1/c_hat_l) of Eq. (8), from the
    per-level capacity multipliers of ``topology.per_level_ratios``.
    Normalized to population mean 1 over experts (weighted by
    ``level_sizes`` when given); ``norm="softmax"`` reweights the
    mean-normalized inverse capacities and renormalizes the same way."""
    inv = np.array([1.0 / max(r, 1e-9) for r in ratios], dtype=np.float64)

    def _pop_mean(v):
        if level_sizes is not None:
            w = np.asarray(level_sizes, dtype=np.float64)
            return float((v * w).sum() / max(w.sum(), 1.0))
        return float(v.mean())

    p = inv / max(_pop_mean(inv), 1e-12)
    if norm == "softmax":
        e = np.exp(p - p.max())
        p = e / max(_pop_mean(e), 1e-12)
    elif norm != "sum":
        raise ValueError(f"unknown norm {norm!r}; expected 'sum' or 'softmax'")
    return tuple(float(v) for v in p)
