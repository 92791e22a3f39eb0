"""Span tracing: nested wall-clock timing that lands in the metrics registry.

    trace = SpanTracer(registry)
    with trace.span("plan_build"):
        plan = plan_for(g, ...)

Every closed span records its duration into the histogram
``span_seconds{span="<path>"}`` in the tracer's registry and appends a
bounded ring-buffer record (for the JSON exporter's ``spans`` section).
Spans opened inside an active span on the same thread get a "/"-joined
path (``serve/plan_build``), so the naming convention in
docs/observability.md falls out of call structure instead of discipline.

Port of `src/repro/obs/trace.py`; the only change is the close-time sync.

**Async-dispatch caveat** (the reason this exists as a class and not three
lines of `perf_counter`): a CUDA launch returns before the device finishes,
so a naive span around one times the *enqueue*, not the work.  Pass the
computation's output through ``span.sync(out)`` — at span close the tracer
calls ``torch.cuda.synchronize`` on the device of every CUDA tensor in it
(CPU tensors and plain values need no wait), so the recorded duration
covers the device work.  ``SpanTracer(block_until_ready=True)`` makes that the
default for every span that registered a sync value; ``span(...,
block=False)`` opts a single span out.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["Span", "SpanTracer"]


def _synchronize(value) -> None:
    """Wait for the device work behind ``value``: a tensor, or a list /
    tuple / dict of them.  Only CUDA tensors wait."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            _synchronize(v)
        return
    import torch
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class Span:
    """One open span.  ``sync(x)`` registers device values to block on at
    close (and returns ``x``, so it wraps call sites inline); ``note()``
    attaches key=value attributes to the exported record."""

    __slots__ = ("path", "t_start", "duration_s", "attrs", "_sync")

    def __init__(self, path: str, t_start: float, attrs: dict):
        self.path = path
        self.t_start = t_start
        self.duration_s: Optional[float] = None
        self.attrs = attrs
        self._sync: Any = None

    def sync(self, value):
        self._sync = value
        return value

    def note(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self


class SpanTracer:
    """Factory for `Span` contexts bound to one `MetricsRegistry`.

    Arguments
    ---------
    registry : the sink; span durations become
        ``span_seconds{span=path}`` histograms there.
    block_until_ready : default for the per-span ``block`` flag — when
        True, spans that registered a ``sync`` value block on it before
        taking the end timestamp (honest device timings).
    max_spans : ring-buffer bound on retained span records (the JSON
        exporter's trace section); older records are dropped, histograms
        keep counting.
    """

    def __init__(self, registry: MetricsRegistry, *,
                 block_until_ready: bool = False, max_spans: int = 256):
        self.registry = registry
        self.block_until_ready = block_until_ready
        self._records: deque = deque(maxlen=max_spans)
        self._local = threading.local()
        self._t0 = time.perf_counter()
        # compact per-tracer thread ids: the Chrome-trace exporter wants
        # small stable track numbers, not 64-bit thread idents
        self._tids: dict = {}
        self._tid_lock = threading.Lock()

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._tid_lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            return tid

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, *, block: Optional[bool] = None, **attrs):
        stack = self._stack()
        path = "/".join([s.path for s in stack[-1:]] + [name])
        sp = Span(path, time.perf_counter(), attrs)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            if (self.block_until_ready if block is None else block) \
                    and sp._sync is not None:
                _synchronize(sp._sync)
            sp.duration_s = time.perf_counter() - sp.t_start
            self.registry.histogram(
                "span_seconds", labels={"span": path},
                desc="wall-clock span durations (repro.obs.trace)",
            ).observe(sp.duration_s)
            # tid + thread name ride in every record: the Chrome-trace
            # exporter needs a per-thread track, the JSON exporter's
            # ``spans`` section gets attributable multi-thread traces
            self._records.append({
                "span": path,
                "t_rel_s": round(sp.t_start - self._t0, 6),
                "duration_s": round(sp.duration_s, 6),
                "tid": self._tid(),
                "thread": threading.current_thread().name,
                **({"attrs": dict(sp.attrs)} if sp.attrs else {}),
            })

    def records(self) -> list:
        """Retained span records, oldest first (bounded by max_spans)."""
        return list(self._records)
