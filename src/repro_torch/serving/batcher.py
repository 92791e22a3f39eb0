"""Batchers: coalesce concurrent node-prediction requests.

Port of `src/repro/serving/batcher.py` (framework-free, carried over
verbatim).

Three policies, all deterministic and thread-free by design — callers
drive them with an explicit clock (``now`` timestamps), so trace replays
are reproducible, property tests (tests/test_serve_async.py) can explore
the close-time invariants without real sleeps, and the async engine can
hold them under its own lock.

* `MicroBatcher` — the original synchronous micro-batcher (size budget +
  optional fixed wait on the oldest request).  `ServingEngine`'s
  ``submit``/``step`` flow still runs on it.
* `ClockBatcher` — the fixed-window baseline: a batch closes ``window``
  seconds after it OPENED (the oldest queued request's submit time),
  regardless of how much latency budget its requests actually have.  This
  is the policy the reference's serving benchmark measures the deadline batcher
  against.
* `DeadlineBatcher` — deadline-aware continuous batching: the planned
  close time is derived from the requests' SLO deadlines minus a measured
  compute estimate (`est_fn`, fed from the engine's
  ``serve_batch_compute_seconds`` histogram) and a safety margin, so the
  batch closes exactly as late as the tightest deadline allows — maximal
  coalescing without planning to miss an SLO.  An optional ``idle_gap``
  closes early when arrivals stop (the tail of an open-loop trace should
  not sit out its whole budget).

Close-time invariants (property-tested):

  * ``close_at(now) + est + margin <= min(deadline over queued)`` — no
    admitted request's deadline is exceeded by the planned close time;
  * ``len(pop(now)) <= max_batch`` — never exceeds the size cap;
  * FIFO order is preserved within a batcher.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, List, Optional

import numpy as np

__all__ = ["ClockBatcher", "DeadlineBatcher", "MicroBatcher", "Request"]


@dataclasses.dataclass
class Request:
    """One node-level prediction request against the resident graph
    (the synchronous `ServingEngine` flavor; the async tier uses
    `serving.admission.AsyncRequest`)."""

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


class _QueueBatcher:
    """Shared FIFO mechanics of the async-tier batchers.  Subclasses
    define `close_at` — the planned close time of the currently open
    batch; `due` adds the size cap on top."""

    def __init__(self, *, max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self._queue: deque = deque()
        self._last_arrival = -math.inf

    def put(self, req, now: Optional[float] = None) -> None:
        self._queue.append(req)
        self._last_arrival = req.t_submit if now is None else now

    def pending(self) -> int:
        return len(self._queue)

    def oldest_deadline(self) -> float:
        """Earliest deadline among queued requests (inf when empty) — the
        engine's cross-tenant EDF pick key."""
        if not self._queue:
            return math.inf
        return min(r.deadline for r in self._queue)

    def close_at(self, now: float) -> float:
        raise NotImplementedError

    def due(self, now: float) -> bool:
        """True when the open batch should fire: size cap reached or the
        planned close time has arrived."""
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        return now >= self.close_at(now)

    def pop(self, now: Optional[float] = None) -> List:
        """Dequeue up to max_batch requests in FIFO order."""
        out = []
        while self._queue and len(out) < self.max_batch:
            out.append(self._queue.popleft())
        return out


class ClockBatcher(_QueueBatcher):
    """Fixed-window baseline: close ``window`` seconds after batch open.

    The window is static — it neither knows how much budget the queued
    requests have left nor notices that arrivals have stopped.  Tuning it
    is the classic serving dilemma: small windows fire undersized batches
    (per-launch overhead dominates), large windows burn latency budget
    idling.  `DeadlineBatcher` replaces the dilemma with the budget
    itself.
    """

    def __init__(self, *, max_batch: int, window: float):
        super().__init__(max_batch=max_batch)
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        self.window = window

    def close_at(self, now: float) -> float:
        if not self._queue:
            return math.inf
        return self._queue[0].t_submit + self.window


class DeadlineBatcher(_QueueBatcher):
    """Deadline-aware continuous batching (the tentpole policy).

    The planned close time of the open batch is

        min( tightest deadline - est() - margin,        # SLO slack
             last arrival + idle_gap )                  # arrivals stopped

    where ``est()`` is the caller's current compute estimate (the engine
    passes a reader over its ``serve_batch_compute_seconds`` histogram
    p90, so the estimate tracks the measured cost of firing a batch) and
    ``margin`` absorbs scheduling jitter.  By construction

        close_at(now) + est() + margin <= min(deadline)

    i.e. the batch is PLANNED to complete inside every queued request's
    budget; a batch only misses its SLO when compute overruns the
    estimate or the system is saturated — never because the batcher
    idled past the budget.

    ``idle_gap`` (optional) bounds how long the batcher waits after the
    last arrival: once traffic pauses, waiting cannot grow the batch, so
    it closes after ``idle_gap`` seconds of silence instead of sitting
    out the remaining slack.
    """

    def __init__(self, *, max_batch: int, est_fn: Optional[Callable[[], float]] = None,
                 margin: float = 0.002, idle_gap: Optional[float] = None):
        super().__init__(max_batch=max_batch)
        if margin < 0:
            raise ValueError(f"margin must be >= 0, got {margin}")
        if idle_gap is not None and idle_gap < 0:
            raise ValueError(f"idle_gap must be >= 0, got {idle_gap}")
        self.est_fn = est_fn
        self.margin = margin
        self.idle_gap = idle_gap

    def estimate(self) -> float:
        """Current compute estimate, clamped to a finite non-negative
        value (an empty histogram reads NaN; a garbage estimate must not
        push close times to +/-inf)."""
        if self.est_fn is None:
            return 0.0
        est = float(self.est_fn())
        if not math.isfinite(est) or est < 0.0:
            return 0.0
        return est

    def close_at(self, now: float) -> float:
        if not self._queue:
            return math.inf
        t = self.oldest_deadline() - self.estimate() - self.margin
        if self.idle_gap is not None:
            t = min(t, self._last_arrival + self.idle_gap)
        return t
