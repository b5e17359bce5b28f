"""Plain PyTorch version of flash attention (GQA + causal + sliding window):
the model's reference attention ``layers._sdpa`` at positions
``0..Sq-1`` / ``0..Sk-1`` (the counterpart of
``repro/kernels/flash_attn/ref.py``)."""

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: int = 0):
    from repro_torch.models.layers import _sdpa
    Sq, Sk = q.shape[1], k.shape[1]
    return _sdpa(q, k, v, causal=causal, sliding_window=sliding_window,
                 q_positions=torch.arange(Sq, device=q.device),
                 k_positions=torch.arange(Sk, device=q.device))
