"""Parameters from the JAX package's layout, so both packages can compute
with the same weights.

The JAX params pytree (converted leaf by leaf to numpy arrays) stacks the
repeated layer group on a leading ``groups`` axis; this port keeps one
dict per layer.  :func:`params_from_numpy` unstacks it.  bfloat16 numpy
arrays (the ``ml_dtypes`` type) are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

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


def params_from_numpy(tree, ctx: transformer.ModelCtx, device=None):
    """``{"embed", "final_norm", "prefix{i}", "groups"}`` numpy tree ->
    ``{"embed", "final_norm", "layers": [...]}`` tensors on ``device``
    (default ``ctx.device``)."""
    device = device or ctx.device
    prefix, group, n_groups = transformer.layer_plan(ctx.arch)
    out = {"embed": _map(tree["embed"], lambda a: _tensor(a, device)),
           "final_norm": _map(tree["final_norm"],
                              lambda a: _tensor(a, device))}
    per_layer = [_map(tree[f"prefix{i}"], lambda a: _tensor(a, device))
                 for i in range(len(prefix))]
    for g in range(n_groups):
        for j in range(len(group)):
            per_layer.append(_map(tree["groups"][f"sub{j}"],
                                  lambda a, g=g: _tensor(np.asarray(a)[g],
                                                         device)))
    out["layers"] = per_layer
    return out
