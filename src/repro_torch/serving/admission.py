"""Admission control for the async serving tier: SLO classes, async

Port of `src/repro/serving/admission.py` (framework-free, carried over
verbatim).

requests, and the bounded per-tenant admission queue.

Every request enters the system through `AdmissionQueue.submit`, which
makes the accounting invariant the whole tier is tested against explicit:

    submitted == completed + rejected + in_queue_or_flight

A request is NEVER silently dropped — it either completes with a result or
reaches ``status == "rejected"`` with a reason (``queue_full`` at
admission, ``closed`` after shutdown began, ``shutdown`` for requests
drained-out by `AsyncServingEngine.close`, ``error`` when the executor
raised).  `tests/test_serve_async.py` races submitters against the worker
and asserts the invariant exactly.

SLO classes: a tenant is admitted under an `SLOClass` — a named latency
budget.  The deadline stamped here (``t_submit + slo_s``) is what the
deadline-aware batcher (`serving.batcher.DeadlineBatcher`) plans batch
close times against, and what the engine's per-tenant
``serve_slo_met_total`` / ``serve_slo_missed_total`` counters score
completions against.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

__all__ = ["SLOClass", "AsyncRequest", "AdmissionQueue", "slo_classes"]


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named latency budget (seconds). Tenants are admitted under one."""

    name: str
    slo_s: float

    def __post_init__(self):
        if not self.slo_s > 0:
            raise ValueError(f"SLO budget must be > 0, got {self.slo_s}")


def slo_classes(base_s: float) -> tuple[SLOClass, SLOClass, SLOClass]:
    """The standard three-tier ladder scaled off a base budget: gold gets
    the base, silver 2x, bronze 4x.  `launch.serve_gnn --tenants K` cycles
    tenants through these."""
    return (SLOClass("gold", base_s), SLOClass("silver", 2.0 * base_s),
            SLOClass("bronze", 4.0 * base_s))


@dataclasses.dataclass
class AsyncRequest:
    """One in-flight node-prediction request with a completion event.

    Terminal states: ``done`` (``result`` holds the logits row) or
    ``rejected`` (``reject_reason`` says why).  ``wait()`` blocks the
    submitting thread until either.
    """

    rid: int
    tenant: str
    seed: int
    t_submit: float
    deadline: float
    status: str = "pending"            # "pending" | "done" | "rejected"
    t_done: float = -1.0
    result: Optional[np.ndarray] = None
    reject_reason: Optional[str] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def terminal(self) -> bool:
        return self.status != "pending"

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request reaches a terminal state."""
        return self._event.wait(timeout)

    def complete(self, result: np.ndarray, now: float) -> None:
        self.result = result
        self.t_done = now
        self.status = "done"
        self._event.set()

    def reject(self, reason: str, now: float) -> None:
        self.reject_reason = reason
        self.t_done = now
        self.status = "rejected"
        self._event.set()


class AdmissionQueue:
    """Bounded admission for one tenant, in front of its batcher.

    Not itself locked — the owning engine serializes every call under its
    single condition variable (one lock for admission + batching + the
    worker's scheduling decisions keeps the cross-tenant EDF pick
    consistent).  What lives here is the admission POLICY: capacity
    check, closed check, and the submitted/rejected bookkeeping the
    accounting invariant is audited against.
    """

    def __init__(self, name: str, *, capacity: int, slo: SLOClass):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.slo = slo
        self.submitted = 0
        self.completed = 0
        self.rejected = 0

    def admit(self, req: AsyncRequest, depth: int, closed: bool,
              now: float) -> Optional[str]:
        """Account for one submission; returns a rejection reason or None
        (admitted).  ``depth`` is the tenant's current queue depth."""
        self.submitted += 1
        if closed:
            req.reject("closed", now)
            self.rejected += 1
            return "closed"
        if depth >= self.capacity:
            req.reject("queue_full", now)
            self.rejected += 1
            return "queue_full"
        return None

    def on_completed(self, n: int = 1) -> None:
        self.completed += n

    def on_rejected(self, n: int = 1) -> None:
        self.rejected += n

    @property
    def accounted(self) -> int:
        """Terminal requests so far (completed + rejected)."""
        return self.completed + self.rejected
