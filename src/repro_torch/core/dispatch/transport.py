"""Transport of the gather path (the counterpart of
``repro/core/dispatch/transport.py``: ``expert_segments`` and
``GatherTransport``).  Single device in this slice: gather, reduce and
slice are identities; the multi-rank ``torch.distributed`` transport
comes later.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.dispatch.base import EPSpec


def expert_segments(num_experts: int, rows_per_expert: int) -> tuple:
    """Static [E + 1] segment offsets: expert ``e`` owns flat rows
    ``offs[e]:offs[e + 1]`` of the [E * rows, d] view."""
    return tuple(rows_per_expert * e for e in range(num_experts + 1))


@dataclasses.dataclass(frozen=True)
class GatherTransport:
    """Weights-stationary transport: gather tokens, sum partial outputs."""

    ep: EPSpec
    tokens_replicated: bool = False

    def __post_init__(self):
        if self.ep.ep_world != 1:
            raise NotImplementedError(
                f"GatherTransport over {self.ep.ep_world} ranks needs the "
                f"torch.distributed transport, not ported yet")

    def gather(self, x):
        """[T_local, d] -> [T_global, d]: the identity on one rank."""
        return x

    def reduce(self, y):
        """Sum of the ranks' partial expert outputs: the identity."""
        return y

    def slice_local(self, y, my_rank: int, T: int):
        """[T_global, d] -> this rank's [T_local, d] slice."""
        return y
