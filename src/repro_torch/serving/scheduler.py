"""Request scheduler for continuous-batching serving.

Pure-Python control plane (a copy of ``repro/serving/scheduler.py``,
which uses only the standard library).  A fixed pool of decode slots
(the batch rows of the slotted KV cache) is managed as a free heap —
``take`` admits pending requests into the lowest free slot ids (so a freed
slot is deterministically reused first), ``on_token`` advances a stream,
and ``complete`` evicts it and returns the finished stream.  The data
plane (prefill packing, cache insert/evict, the decode loop) lives in
``repro_torch.serving.batching`` / ``repro_torch.serving.engine``.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque


@dataclasses.dataclass
class Request:
    """One generation request.

    ``tokens`` is the prompt (any 1-D int sequence), ``max_new_tokens`` the
    stream's length budget; ``temperature`` 0 means greedy.  ``frontend``
    optionally carries a per-request modality array (vision patches for the
    vlm family), spliced over the leading prompt positions at prefill.
    ``deadline_s`` is a wall-clock budget measured from admission — a
    stream past it is evicted mid-decode (partial output kept, slot freed)
    so one stuck stream can't wedge the engine; None means no deadline.
    """
    uid: int
    tokens: object
    max_new_tokens: int
    temperature: float = 0.0
    frontend: object | None = None
    deadline_s: float | None = None

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class Stream:
    """A request occupying a decode slot."""
    request: Request
    slot: int
    generated: list = dataclasses.field(default_factory=list)
    t_admitted: float = 0.0
    t_finished: float = 0.0
    evicted: bool = False            # deadline eviction (partial output)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.request.max_new_tokens

    @property
    def tokens_per_sec(self) -> float:
        dt = max(self.t_finished - self.t_admitted, 1e-9)
        return len(self.generated) / dt


class Scheduler:
    """Admits requests into a fixed pool of ``num_slots`` decode slots."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self._free = list(range(num_slots))
        heapq.heapify(self._free)
        self._pending = deque()
        self._active = {}            # slot -> Stream
        self.finished = []

    # -- queue side ---------------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.prompt_len < 1:
            raise ValueError(f"request {request.uid}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(f"request {request.uid}: max_new_tokens < 1")
        self._pending.append(request)

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def has_work(self) -> bool:
        return bool(self._pending or self._active)

    def active_slots(self):
        return sorted(self._active)

    def stream(self, slot: int) -> Stream:
        return self._active[slot]

    # -- admission ----------------------------------------------------------

    def take(self, max_n: int, now: float | None = None):
        """Admit up to ``max_n`` pending requests into free slots.

        Returns the admitted ``[(slot, request), ...]`` (possibly empty when
        the pool is exhausted or the queue is drained); the caller prefills
        the pack and inserts it into the slot cache.
        """
        admits = []
        while self._pending and self._free and len(admits) < max_n:
            slot = heapq.heappop(self._free)
            req = self._pending.popleft()
            self._active[slot] = Stream(request=req, slot=slot,
                                        t_admitted=now if now is not None
                                        else time.time())
            admits.append((slot, req))
        return admits

    # -- decode progress -----------------------------------------------------

    def on_token(self, slot: int, token: int) -> bool:
        """Record one generated token for the stream in ``slot``; returns
        True when the stream just reached its length budget."""
        stream = self._active[slot]
        if stream.done:
            raise ValueError(f"slot {slot}: stream already complete")
        stream.generated.append(int(token))
        return stream.done

    def complete(self, slot: int, now: float | None = None) -> Stream:
        """Evict the stream in ``slot``, free the slot for reuse, and
        return the finished stream."""
        stream = self._active.pop(slot)
        stream.t_finished = now if now is not None else time.time()
        heapq.heappush(self._free, slot)
        self.finished.append(stream)
        return stream

    # -- deadlines -----------------------------------------------------------

    def expired(self, now: float) -> list:
        """Active slots whose stream has outlived its request deadline
        (``deadline_s`` from admission; None = never expires)."""
        return sorted(
            slot for slot, s in self._active.items()
            if s.request.deadline_s is not None
            and now - s.t_admitted >= s.request.deadline_s)

    def evict(self, slot: int, now: float | None = None) -> Stream:
        """Deadline-evict the stream in ``slot``: the partial output is
        kept on the finished list (``evicted`` flag set) and the slot
        returns to the free pool — the caller zeroes the slot's KV rows."""
        stream = self._active.pop(slot)
        stream.evicted = True
        stream.t_finished = now if now is not None else time.time()
        heapq.heappush(self._free, slot)
        self.finished.append(stream)
        return stream
