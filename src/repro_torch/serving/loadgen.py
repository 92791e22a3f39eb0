"""Deterministic Zipf load generation for the serving driver.

Port of `src/repro/serving/loadgen.py` (framework-free, carried over
verbatim).

A load run is split into two phases with a hard determinism boundary
between them:

* **schedule construction** (`build_schedule`) — pure function of a
  `LoadSpec`: same seed ⇒ byte-identical request trace (arrival offsets,
  tenant assignment, seed nodes).  This is what makes
  serving numbers attributable run-to-run: two runs of the
  same profile serve the exact same traffic, and only the measured
  timings differ.
* **replay** (`run_schedule`) — walks the schedule against a live
  `AsyncServingEngine`, sleeping to each arrival offset (open loop) or
  submitting everything at once (``rate_rps=inf`` — the burst profile
  used to measure saturation throughput).

Seed popularity is Zipf over a small hot set (`zipf_seeds`, the same
distribution `launch.serve_gnn` has always replayed): a skewed hot set is
what makes plan/executor caching pay off in production, per the paper's
amortization thesis.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["Arrival", "LoadSpec", "build_schedule", "run_schedule",
           "zipf_seeds"]


def zipf_seeds(num_nodes: int, requests: int, *, zipf: float = 1.1,
               hot_fraction: float = 0.05, seed: int = 0,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Zipf-popularity seed nodes: ranks Zipf-weighted over a random node
    permutation, so a small hot set dominates the trace."""
    rng = np.random.default_rng(seed) if rng is None else rng
    pool = max(1, int(num_nodes * hot_fraction))
    nodes = rng.permutation(num_nodes)[:pool]
    ranks = np.arange(1, pool + 1, dtype=np.float64)
    p = ranks ** (-zipf)
    p /= p.sum()
    return nodes[rng.choice(pool, size=requests, p=p)]


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: offset from trace start, tenant, seed node."""

    t: float
    tenant: str
    seed: int


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Deterministic description of a load profile.

    ``rate_rps=math.inf`` collapses every arrival to t=0 (burst /
    closed-pressure profile — measures saturation throughput);
    ``arrival="uniform"`` spaces arrivals evenly at the offered rate,
    ``"poisson"`` draws exponential inter-arrival gaps (seeded).
    """

    requests: int = 256
    rate_rps: float = 500.0
    zipf: float = 1.1
    hot_fraction: float = 0.05
    tenants: tuple = ("default",)
    arrival: str = "uniform"       # "uniform" | "poisson"
    seed: int = 0

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError("requests must be >= 1")
        if not self.rate_rps > 0:
            raise ValueError("rate_rps must be > 0")
        if self.arrival not in ("uniform", "poisson"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if not self.tenants:
            raise ValueError("need at least one tenant")


def build_schedule(num_nodes: int, spec: LoadSpec) -> list[Arrival]:
    """Pure, deterministic: same (num_nodes, spec) ⇒ identical schedule.

    One seeded generator drives seed-node choice, arrival gaps and tenant
    assignment in a FIXED draw order, so the trace replays exactly
    (tests/test_serve_async.py asserts equality)."""
    rng = np.random.default_rng(spec.seed)
    seeds = zipf_seeds(num_nodes, spec.requests, zipf=spec.zipf,
                       hot_fraction=spec.hot_fraction, rng=rng)
    if math.isinf(spec.rate_rps):
        offsets = np.zeros(spec.requests)
    elif spec.arrival == "poisson":
        offsets = np.cumsum(rng.exponential(1.0 / spec.rate_rps,
                                            size=spec.requests))
    else:
        offsets = np.arange(spec.requests) / spec.rate_rps
    tenant_ix = rng.integers(0, len(spec.tenants), size=spec.requests)
    return [Arrival(t=float(offsets[i]), tenant=spec.tenants[int(tenant_ix[i])],
                    seed=int(seeds[i]))
            for i in range(spec.requests)]


def run_schedule(engine, schedule: Sequence[Arrival], *,
                 drain_timeout: Optional[float] = 120.0) -> dict:
    """Replay a schedule against an `AsyncServingEngine` (open loop: the
    generator never waits for results, only for arrival offsets), then
    `drain()` — letting the engine's own batch-close policy handle the
    tail — and measure.

    Returns wall-clock measurements over the replay::

        {"requests", "wall_s", "throughput_rps", "drained"}

    plus the submitted `AsyncRequest` list under ``"requests_detail"``
    for correctness cross-checks.  Throughput counts COMPLETED requests
    over the span from first submit to last terminal event.
    """
    t0 = time.perf_counter()
    reqs = []
    for a in schedule:
        dt = (t0 + a.t) - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        reqs.append(engine.submit(a.seed, tenant=a.tenant))
    drained = engine.drain(timeout=drain_timeout)
    t_last = max((r.t_done for r in reqs if r.terminal), default=t0)
    wall = max(t_last - t0, 1e-9)
    completed = sum(r.status == "done" for r in reqs)
    return {"requests": len(reqs), "completed": completed,
            "wall_s": wall, "throughput_rps": completed / wall,
            "drained": drained, "requests_detail": reqs}
