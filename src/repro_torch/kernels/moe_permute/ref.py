"""Plain PyTorch versions of the token permutation pair (the counterpart of
``repro/kernels/moe_permute/ref.py``).

Sentinel convention: an index equal to the source row count addresses an
implicit all-zero row — padded capacity slots point at it on the way in,
dropped gate picks point at it on the way out.
"""

import torch


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    """Append the sentinel zero row: [R, d] -> [R + 1, d]."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)


def permute_ref(x, slot_to_token):
    """x: [T, d]; slot_to_token: [S] int in [0, T] (T = sentinel).
    Returns [S, d] with row ``s`` = ``x[slot_to_token[s]]`` (zeros for
    sentinel slots)."""
    return _with_zero_row(x).index_select(0, slot_to_token.long())


def unpermute_ref(y, inv_idx, inv_w):
    """y: [S, d]; inv_idx: [T, K] int in [0, S] (S = sentinel); inv_w:
    [T, K].  Returns the float32 [T, d]
    ``out[t] = sum_k inv_w[t, k] * y[inv_idx[t, k]]``."""
    g = _with_zero_row(y)[inv_idx.long()].to(torch.float32)
    return torch.sum(g * inv_w[..., None].to(torch.float32), dim=1)
