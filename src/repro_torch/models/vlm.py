"""Vision frontend stub for InternVL2 (the counterpart of
``repro/models/vlm.py``).

The real frontend is InternViT-6B (448 px, pixel-shuffled to 256 tokens a
tile) and an MLP projector.  The ViT is the sanctioned stub:
:func:`make_patches` gives 256 patch embeddings at the ViT's output width
(1024), drawn from the caller's numpy generator as the reference draws
them (the same seed gives bit-equal arrays); the in-model 2-layer
projector (``params["proj"]``, ``models/transformer.py``) maps them into
d_model, and they replace the first ``frontend_len`` token positions.
"""

from __future__ import annotations

import numpy as np
import torch

VIT_WIDTH = 1024          # stubbed vision-encoder output width
PATCHES_PER_IMAGE = 256


def patch_shape(batch: int, arch) -> tuple:
    return (batch, arch.frontend_len or PATCHES_PER_IMAGE, VIT_WIDTH)


def make_patches(rng: np.random.Generator, batch: int, arch) -> torch.Tensor:
    """Unit-variance stand-in patch embeddings, float32 on the CPU."""
    return torch.from_numpy(
        rng.standard_normal(patch_shape(batch, arch)).astype(np.float32))
