"""Dependency-free metrics primitives: counters, gauges, bounded histograms.

Port of `src/repro/obs/metrics.py` (carried over verbatim).

The runtime's self-observation layer (docs/observability.md).  Everything
here is plain Python + `threading.Lock` — no torch, no numpy, no external
metrics client — so it can be imported from any layer (serving, sampling,
runtime, distributed, benchmarks) without dragging device state along.

Design constraints, in order:

  * **Bounded memory.**  A serving engine under sustained traffic must not
    grow per-request state; `Histogram` keeps a FIXED set of bucket
    counters (plus count/sum/min/max) regardless of how many observations
    it absorbs.  Percentiles (p50/p90/p99) are estimated by interpolating
    within the bucket that crosses the target rank — exact enough for
    SLO reporting when buckets are geometric (error is bounded by the
    bucket growth factor), and O(num_buckets) to compute.
  * **Thread safety.**  The sampled loader's prefetch worker, a train
    thread and a serving flush may all touch the same registry; every
    mutation happens under a per-metric lock and every snapshot is taken
    under it, so counts are never lost (tests/test_obs.py races them).
  * **One registry.**  `MetricsRegistry` is get-or-create: two components
    asking for the same (name, labels) share the metric object, which is
    what lets `summary()`-style views and the exporters agree by
    construction.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "exponential_bounds", "pow2_bounds"]


def exponential_bounds(lo: float = 1e-6, growth: float = 2.0,
                       n: int = 31) -> Tuple[float, ...]:
    """Geometric bucket upper bounds ``lo * growth**k`` for k in [0, n).

    The default (1 µs .. ~1000 s, factor 2) is the latency ladder every
    ``*_seconds`` histogram uses: 31 buckets cover nine decades with a
    worst-case within-bucket percentile error of 2x, far below run-to-run
    jitter at the millisecond scales this runtime reports.
    """
    return tuple(lo * growth ** k for k in range(n))


def pow2_bounds(hi: int) -> Tuple[float, ...]:
    """Power-of-two bounds 1, 2, 4, ... >= hi — the natural ladder for
    size-like metrics (batch sizes, node counts) in a pow2-bucketed
    runtime: every padded shape lands exactly on a bucket edge."""
    bounds, b = [], 1
    while b < hi:
        bounds.append(float(b))
        b *= 2
    bounds.append(float(b))
    return tuple(bounds)


class _Metric:
    """Shared identity + lock.  ``labels`` is a sorted tuple of (k, v)
    string pairs; together with ``name`` it is the registry key."""

    kind = "untyped"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 desc: str = "", unit: str = ""):
        self.name = name
        self.labels = labels
        self.desc = desc
        self.unit = unit
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (requests served, cache misses)."""

    kind = "counter"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge(_Metric):
    """Point-in-time value (queue depth, halo bytes, buckets resident)."""

    kind = "gauge"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}


class Histogram(_Metric):
    """Fixed-bucket histogram with percentile estimation.

    ``bounds`` are inclusive upper edges of the finite buckets; one
    implicit overflow bucket catches everything above the last edge.
    Memory is O(len(bounds)) FOREVER — this is the bounded replacement for
    the grow-forever stat lists the serving engine used to keep.

    ``percentile(q)`` walks the cumulative counts to the bucket containing
    rank ``q/100 * count`` and interpolates linearly inside it, clamped to
    the observed min/max (so tight distributions report exact-ish values
    even with coarse buckets, and the overflow bucket interpolates toward
    the true max instead of infinity).
    """

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 desc: str = "", unit: str = "",
                 bounds: Optional[Sequence[float]] = None):
        super().__init__(name, labels, desc, unit)
        b = tuple(float(x) for x in (bounds if bounds is not None
                                     else exponential_bounds()))
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram {name}: bounds must be strictly "
                             f"increasing, got {b}")
        self.bounds = b
        self._counts = [0] * (len(b) + 1)   # +1: overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect without importing bisect: bounds are short (<= ~40) and a
        # manual binary search keeps this allocation-free on the hot path
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else float("nan")

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]); NaN when empty."""
        with self._lock:
            counts = list(self._counts)
            total, vmin, vmax = self._count, self._min, self._max
        if total == 0:
            return float("nan")
        rank = q / 100.0 * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else vmax
                lo, hi = max(lo, vmin if prev == 0 else lo), min(hi, vmax)
                if hi <= lo:
                    return float(min(max(lo, vmin), vmax))
                frac = (rank - prev) / c
                return float(min(max(lo + frac * (hi - lo), vmin), vmax))
        return float(vmax)

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            out = {"count": self._count, "sum": self._sum,
                   "min": self._min if self._count else None,
                   "max": self._max if self._count else None}
        out["p50"] = self.percentile(50)
        out["p90"] = self.percentile(90)
        out["p99"] = self.percentile(99)
        # non-zero buckets only: [upper_bound_or_None(=overflow), count]
        out["buckets"] = [
            [self.bounds[i] if i < len(self.bounds) else None, c]
            for i, c in enumerate(counts) if c]
        return out

    def cumulative_buckets(self) -> list:
        """[(upper_bound, cumulative_count)] over ALL finite buckets plus
        the (+Inf, total) terminator — the Prometheus exposition shape."""
        with self._lock:
            counts = list(self._counts)
        cum, out = 0, []
        for i, b in enumerate(self.bounds):
            cum += counts[i]
            out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


class MetricsRegistry:
    """Get-or-create registry: the single sink every subsystem reports to.

    ``counter`` / ``gauge`` / ``histogram`` return the EXISTING metric when
    the (name, labels) pair was seen before — re-registration with a
    different kind raises, mismatched histogram bounds raise.  `snapshot()`
    returns a JSON-able list of every metric's state (the exporters in
    `repro.obs.export` build on it).

    Example
    -------
    >>> reg = MetricsRegistry()
    >>> reg.counter("serve_requests_total").inc()
    >>> h = reg.histogram("serve_request_latency_seconds")
    >>> h.observe(0.003); h.percentile(50)
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[tuple, _Metric]" = {}

    @staticmethod
    def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
        if not labels:
            return ()
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _get_or_create(self, cls, name: str, labels, desc, unit, **kw):
        lk = self._label_key(labels)
        key = (name, lk)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, lk, desc=desc, unit=unit,
                                             **kw)
                return m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        if kw.get("bounds") is not None and tuple(
                float(x) for x in kw["bounds"]) != m.bounds:
            raise ValueError(f"histogram {name!r} re-registered with "
                             f"different bounds")
        return m

    def counter(self, name: str, *, desc: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, labels, desc, "")

    def gauge(self, name: str, *, desc: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, labels, desc, "")

    def histogram(self, name: str, *, desc: str = "", unit: str = "s",
                  labels: Optional[dict] = None,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, labels, desc, unit,
                                   bounds=bounds)

    def get(self, name: str, labels: Optional[dict] = None):
        """Existing metric or None (read-side lookups, tests)."""
        with self._lock:
            return self._metrics.get((name, self._label_key(labels)))

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> list:
        """JSON-able state of every metric, sorted by (name, labels)."""
        out = []
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            row = {"name": m.name, "type": m.kind,
                   "labels": dict(m.labels)}
            if m.desc:
                row["desc"] = m.desc
            row.update(m.snapshot())
            out.append(row)
        return out
