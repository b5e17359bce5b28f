"""Prefill packing and the slotted KV cache for continuous batching (the
counterpart of ``repro/serving/batching.py``).

``pad_pack`` right-pads a pack of prompts to a fixed (pack, bucket)
shape; ``SlotKVCache`` wraps ``decode.init_cache`` with slot-indexed
insert/evict, both in place.  Padded pack rows carry slot id
``num_slots``, which the insert drops.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import decode as decode_lib


def pick_bucket(length: int, buckets) -> int:
    """Smallest right-pad bucket that fits ``length``."""
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    raise ValueError(f"prompt length {length} exceeds the largest prefill "
                     f"bucket {max(buckets)}")


def pad_pack(prompts, pack: int, buckets, device="cuda"):
    """Right-pad ``prompts`` (1-D int sequences, at most ``pack``) to a
    fixed ``[pack, bucket]`` block.  Returns int32 ``(tokens [pack, L],
    lens [pack])`` on ``device``; padded rows get a one-token dummy prompt
    (lens 1) so gathers at ``lens - 1`` stay in bounds."""
    if len(prompts) > pack:
        raise ValueError(f"pack of {len(prompts)} prompts exceeds width "
                         f"{pack}")
    L = pick_bucket(max((len(p) for p in prompts), default=1), buckets)
    tokens = np.zeros((pack, L), np.int32)
    lens = np.ones((pack,), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = np.asarray(p, np.int32)
        lens[i] = len(p)
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(lens, device=device))


class SlotKVCache:
    """A decode cache with ``num_slots`` batch rows managed as slots."""

    def __init__(self, ctx, num_slots: int, cache_len: int):
        self.ctx = ctx
        self.num_slots = int(num_slots)
        self.cache_len = int(cache_len)
        self.cache = decode_lib.init_cache(ctx, self.num_slots,
                                           self.cache_len)

    def insert(self, src_cache, slot_ids) -> None:
        """Write a prefilled pack cache into ``slot_ids`` (ids >=
        ``num_slots`` are dropped — the padded-pack convention)."""
        decode_lib.cache_insert_slots(self.cache, src_cache, slot_ids)

    def evict(self, slot_ids) -> None:
        """Zero the cache at ``slot_ids`` (pos included)."""
        decode_lib.cache_evict_slots(self.cache, slot_ids)

    def positions(self) -> np.ndarray:
        """Per-slot cache positions [num_slots] (0 = empty/evicted)."""
        return self.cache[0]["mixer"]["pos"].cpu().numpy()
