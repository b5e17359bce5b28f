"""Parameters from the JAX package's layout, so both packages can compute
with the same weights.

The JAX params pytree (converted leaf by leaf to numpy arrays) stacks the
repeated layer group on a leading ``groups`` axis; this port keeps one
dict per layer.  :func:`params_from_numpy` unstacks it and, on a rank of
an EP world, keeps the rank's shard of the expert tensors.
:func:`opt_state_from_numpy` carries the AdamW state across the same way,
so a checkpoint the reference wrote can resume in the port.  bfloat16
numpy arrays (the ``ml_dtypes`` type) are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dispatch.base import EXPERT_PARAMS
from repro_torch.models import model as model_lib
from repro_torch.models import transformer


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(groups, n_groups: int, group_len: int, device) -> list:
    """A stacked ``{"sub{j}": ...}`` group tree -> one dict per layer."""
    return [_map(groups[f"sub{j}"],
                 lambda a, g=g: _tensor(np.asarray(a)[g], device))
            for g in range(n_groups) for j in range(group_len)]


def params_from_numpy(tree, ctx: transformer.ModelCtx, device=None):
    """``{"embed", "final_norm", "prefix{i}", "groups"}`` numpy tree (and a
    vision model's ``"proj"``, an encoder-decoder's ``"enc_groups"`` and
    ``"enc_norm"``) -> ``{"embed", "final_norm", "layers": [...]}``
    tensors on ``device`` (default ``ctx.device``), with ``"proj"``,
    ``"enc_layers": [...]`` and ``"enc_norm"`` where the tree has them."""
    device = device or ctx.device
    prefix, group, n_groups = transformer.layer_plan(ctx.arch)
    out = {name: _map(tree[name], lambda a: _tensor(a, device))
           for name in ("embed", "final_norm")}
    per_layer = [_map(tree[f"prefix{i}"], lambda a: _tensor(a, device))
                 for i in range(len(prefix))]
    per_layer += _unstack(tree["groups"], n_groups, len(group), device)
    if ctx.arch.is_moe:
        lo, hi = ctx.expert_range
        for layer, sub in zip(per_layer, transformer.layer_list(ctx.arch)):
            if sub.ffn == "moe":
                for name in EXPERT_PARAMS:
                    if name in layer["ffn"]:
                        layer["ffn"][name] = layer["ffn"][name][lo:hi].clone()
    out["layers"] = per_layer
    # the rest in init_model's order, so leaf lists line up
    if "proj" in tree:
        out["proj"] = _map(tree["proj"], lambda a: _tensor(a, device))
    if "enc_groups" in tree:
        enc, n_enc = transformer.encoder_plan(ctx.arch)
        out["enc_layers"] = _unstack(tree["enc_groups"], n_enc, len(enc),
                                     device)
        out["enc_norm"] = _map(tree["enc_norm"], lambda a: _tensor(a, device))
    return model_lib.shard_params(out, ctx)


def opt_state_from_numpy(tree, ctx: transformer.ModelCtx, device=None):
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy, ``mu``
    and ``nu`` in the params layout) -> the port's: the moments unstacked
    and expert-sharded as :func:`params_from_numpy` does, the step a
    Python int."""
    return {"mu": params_from_numpy(tree["mu"], ctx, device),
            "nu": params_from_numpy(tree["nu"], ctx, device),
            "step": int(np.asarray(tree["step"]))}
