"""Micro-batcher: coalesce concurrent node-prediction requests.

Port of `MicroBatcher` and `Request` from `src/repro/serving/batcher.py`
(carried over verbatim).  Deterministic and thread-free by design —
callers drive it with an explicit clock (``now`` timestamps), so trace
replays are reproducible.  The deadline and clock batchers of the async
tier wait for its slice.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["MicroBatcher", "Request"]


@dataclasses.dataclass
class Request:
    """One node-level prediction request against the resident graph
    (the synchronous `ServingEngine` flavor)."""

    rid: int
    seed: int
    t_submit: float
    t_done: float = -1.0
    result: Optional[np.ndarray] = None
    status: str = "pending"        # "pending" | "done" | "rejected"

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class MicroBatcher:
    def __init__(self, *, max_batch: int = 16, max_wait: float = 0.0):
        assert max_batch >= 1
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._queue: "deque[Request]" = deque()

    def put(self, req: Request) -> None:
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    def ready(self, now: float) -> bool:
        """True when a batch should fire: size budget met, or the oldest
        request has exhausted the time budget."""
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        return (now - self._queue[0].t_submit) >= self.max_wait

    def pop(self) -> list[Request]:
        """Dequeue up to max_batch requests (FIFO)."""
        out = []
        while self._queue and len(out) < self.max_batch:
            out.append(self._queue.popleft())
        return out

    def drain(self) -> list[Request]:
        """Dequeue EVERYTHING (shutdown path: `ServingEngine.close`)."""
        out = list(self._queue)
        self._queue.clear()
        return out

