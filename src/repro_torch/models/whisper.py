"""Whisper audio frontend stub (the counterpart of
``repro/models/whisper.py``).

The real front end is a log-mel spectrogram and 2 strided Conv1d blocks:
30 s of 16 kHz audio -> 1500 frames of d_model features.  The modality
frontend is the sanctioned stub: :func:`make_frames` gives precomputed
frame embeddings of exactly that shape, drawn from the caller's numpy
generator as the reference draws them (the same seed gives bit-equal
arrays); the encoder-decoder backbone (``models/transformer.py``, family
"audio") consumes them.
"""

from __future__ import annotations

import numpy as np
import torch

FRAMES_PER_CLIP = 1500    # 30 s at 50 Hz after the conv stub


def frame_shape(batch: int, arch) -> tuple:
    return (batch, arch.frontend_len or FRAMES_PER_CLIP, arch.d_model)


def make_frames(rng: np.random.Generator, batch: int, arch) -> torch.Tensor:
    """Unit-variance stand-in frame embeddings, float32 on the CPU."""
    return torch.from_numpy(
        rng.standard_normal(frame_shape(batch, arch)).astype(np.float32))
