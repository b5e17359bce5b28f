"""Deterministic synthetic LM data (the counterpart of
``repro/data/pipeline.py``).

The stream is the reference's, drawn with the same numpy generators, so
its batches are bit-equal to the reference's; they are handed over as
torch tensors on the CPU.  A model with a frontend gets its stub
embeddings too (``"frontend"``: audio frames or vision patches, drawn
after the tokens from the step's generator), and a vision model's
``loss_mask`` is 0 over the patch positions.  No external dataset (the
machines are offline).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import vlm, whisper


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8


class SyntheticLM:
    """Deterministic, restartable synthetic token stream: Zipf draws with
    Markov motifs, so the LM loss has learnable structure."""

    def __init__(self, cfg: DataConfig, arch=None):
        self.cfg = cfg
        self.arch = arch
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # motif table: each token deterministically suggests a follower
        self._next = rng.integers(0, v, size=(v,), dtype=np.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self._probs = p / p.sum()

    def batch(self, step: int) -> dict:
        """Batch for a given step (stateless: random access by step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        base = rng.choice(v, size=(B, S + 1), p=self._probs)
        # with prob .5 follow the motif instead of fresh draw
        follow = rng.random((B, S)) < 0.5
        toks = base.copy()
        for t in range(1, S + 1):
            toks[:, t] = np.where(follow[:, t - 1],
                                  self._next[toks[:, t - 1]], base[:, t])
        out = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
               "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
               "loss_mask": torch.ones((B, S), dtype=torch.float32)}
        if self.arch is not None and self.arch.frontend:
            if self.arch.frontend == "vision":
                out["frontend"] = vlm.make_patches(rng, B, self.arch)
                out["loss_mask"][:, :self.arch.frontend_len] = 0.0
            else:
                out["frontend"] = whisper.make_frames(rng, B, self.arch)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def shard_batch(batch: dict, world=None, device="cpu",
                microbatch: int = 0) -> dict:
    """This rank's rows of a global batch, on ``device``: rank ``r`` of
    ``n`` takes rows ``r * B / n : (r + 1) * B / n``, as the reference's
    ``P(("pod", "data"))`` gives them to the device at coordinates
    ``divmod(r, ...)``.

    With ``microbatch`` ``m < B`` the global batch is ``B / m``
    microbatches of ``m`` consecutive rows, each split over the ranks as
    above (the reference's accumulation scan over a sharded batch): the
    rank's rows are its share of each microbatch, microbatch after
    microbatch."""
    n = 1 if world is None else world.size
    r = 0 if world is None else world.rank
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        m = microbatch if 0 < microbatch < B else B
        if B % m or m % n:
            raise ValueError(f"batch of {B} rows does not split into "
                             f"microbatches of {m} over {n} ranks")
        per = m // n
        rows = [v[i + r * per:i + (r + 1) * per] for i in range(0, B, m)]
        out[k] = torch.cat(rows).to(device) if len(rows) > 1 else \
            rows[0].to(device)
    return out
