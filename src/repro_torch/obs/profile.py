"""On-device measurement harness: honest timings + model-residual metrics.

Port of `src/repro/obs/profile.py` (`Measurement`, `measure`,
`ScheduleProfile`, `ProfileReport`, `profile_plan`).  The analytical
`KernelModel` (paper §5/§7.1) predicts; this module *measures*: `measure`
gives calibrated, outlier-robust wall-clock samples of a callable, and
`profile_plan` attributes time and achieved throughput per schedule
(forward vs backward) so the achieved-vs-predicted residual is a metric
(``kernel_model_residual{schedule,variant}``), not a one-off printout.

Honesty rules:

  * every timed call is closed with ``torch.cuda.synchronize`` on its
    output's device when the output holds a CUDA tensor (the counterpart
    of ``jax.block_until_ready``), so a sample covers device compute, not
    only the launch;
  * warmup is CALIBRATED by default: iterations run until two consecutive
    times agree within ``stable_rel`` (or ``max_warmup`` is hit), which
    absorbs the kernels' build at first use and first-touch allocation;
  * the reported center is an outlier-robust trimmed mean plus p50/p90/min
    — never a lone sample.

On the card a wall sample holds the call's host work (checks, padding,
the launch) as well as its kernels.  For a CUDA output `measure` also
takes ``iters`` device samples (`Measurement.device_samples`): each a
further call queued behind a spin on the stream (``torch.cuda._sleep``,
longer than the call's whole wall time), timed between a pair of CUDA
events, so the time is the device's alone — the split `chip_smoke.py`'s
kernel table reports as "ms" and "dev".  A measured callable therefore
runs ``warmup + iters`` times on the CPU and ``warmup + 2 * iters`` times
on the card.

Module-top imports are stdlib-only (and the tracer's synchronize); torch
and numpy are imported inside the functions that need them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

from repro_torch.obs.trace import _synchronize

__all__ = ["Measurement", "measure", "profile_plan", "ProfileReport",
           "ScheduleProfile"]

# device samples: the spin that queues a call is at least this many clock
# cycles (about 1 ms at the H100's 1.98 GHz boost clock) and at least four
# times the longest wall sample at 2e9 cycles a second
_SPIN_CYCLES = 2_000_000
_SPIN_RATE = 2e9
_SPIN_MAX_CYCLES = 200_000_000


def _quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of pre-sorted samples (numpy's default
    method, so `p50` of the harness == `np.median` of the same samples)."""
    n = len(sorted_xs)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_xs[0])
    pos = q * (n - 1)
    i = int(math.floor(pos))
    if i + 1 >= n:
        return float(sorted_xs[-1])
    frac = pos - i
    return float(sorted_xs[i] + frac * (sorted_xs[i + 1] - sorted_xs[i]))


def _cuda_device(out):
    """The device of the first CUDA tensor in ``out`` (a tensor, or a list
    / tuple / dict of them), or None."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            d = _cuda_device(v)
            if d is not None:
                return d
        return None
    try:
        import torch
    except ImportError:
        return None
    if isinstance(out, torch.Tensor) and out.is_cuda:
        return out.device
    return None


def _block(out):
    """Wait for the device work behind ``out`` (no-op off the card); returns
    ``out``."""
    _synchronize(out)
    return out


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Post-warmup wall-clock samples (seconds) of one callable, and on the
    card its device-only samples (seconds; empty on the CPU)."""

    samples: tuple
    warmup: int          # warmup iterations actually run (calibration incl.)
    device_samples: tuple = ()

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return (sum(self.samples) / len(self.samples)
                if self.samples else float("nan"))

    @property
    def trimmed_mean(self) -> float:
        """Mean with the top and bottom 20% of samples dropped (at least
        one from each side once there are >= 5 samples) — the harness's
        outlier-robust center."""
        xs = sorted(self.samples)
        k = int(len(xs) * 0.2)
        core = xs[k:len(xs) - k] if len(xs) - 2 * k >= 1 else xs
        return sum(core) / len(core) if core else float("nan")

    @property
    def p50(self) -> float:
        return _quantile(sorted(self.samples), 0.50)

    @property
    def p90(self) -> float:
        return _quantile(sorted(self.samples), 0.90)

    @property
    def min(self) -> float:
        return min(self.samples) if self.samples else float("nan")

    @property
    def max(self) -> float:
        return max(self.samples) if self.samples else float("nan")

    @property
    def spread_rel(self) -> float:
        """(p90 - p50) / p50 — the run's own noise estimate, which the
        baseline comparator turns into a per-row tolerance."""
        p50 = self.p50
        return (self.p90 - p50) / p50 if p50 > 0 else float("nan")

    @property
    def device_p50(self) -> float:
        """p50 of the device-only samples (nan on the CPU)."""
        return _quantile(sorted(self.device_samples), 0.50)

    def to_row(self) -> dict:
        """Microsecond-scaled fields merged into benchmark rows, which is
        how recorded p50/p90 spread reaches the persisted baselines."""
        return {
            "p50_us": self.p50 * 1e6,
            "p90_us": self.p90 * 1e6,
            "min_us": self.min * 1e6,
            "mean_us": self.trimmed_mean * 1e6,
            "iters": self.count,
        }


def _device_samples(fn, args, iters: int, dev, longest_s: float) -> tuple:
    """``iters`` device-only times of ``fn(*args)`` (see the module doc)."""
    import torch
    cycles = int(min(max(_SPIN_CYCLES, 4 * longest_s * _SPIN_RATE),
                     _SPIN_MAX_CYCLES))
    out = []
    with torch.cuda.device(dev):
        for _ in range(iters):
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
    return tuple(out)


def measure(fn: Callable, *args, warmup: Optional[int] = None,
            iters: int = 5, max_warmup: int = 8,
            stable_rel: float = 0.25) -> Measurement:
    """Measure ``fn(*args)`` with synchronize-honest timing.

    ``warmup=None`` (default) calibrates: warmup iterations run until two
    consecutive times agree within ``stable_rel`` relative difference
    (minimum 2, maximum ``max_warmup``), which absorbs a kernel's build at
    first use no matter how long it takes.  Pass an int to pin the warmup
    count.  Then ``iters`` timed samples are taken; each sample covers one
    full call including device compute.  When the call returns a CUDA
    tensor, ``iters`` device-only samples follow (see the module doc).
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    ran = 0
    if warmup is None:
        prev = None
        while ran < max_warmup:
            t0 = time.perf_counter()
            _block(fn(*args))
            dt = time.perf_counter() - t0
            ran += 1
            if (ran >= 2 and prev is not None and prev > 0
                    and abs(dt - prev) <= stable_rel * max(dt, prev)):
                break
            prev = dt
    else:
        for _ in range(warmup):
            _block(fn(*args))
        ran = warmup
    samples = []
    dev = None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        dev = _cuda_device(out)
        _block(out)
        samples.append(time.perf_counter() - t0)
    device = (() if dev is None
              else _device_samples(fn, args, iters, dev, max(samples)))
    return Measurement(samples=tuple(samples), warmup=ran,
                       device_samples=device)


@dataclasses.dataclass(frozen=True)
class ScheduleProfile:
    """Measured + modeled view of ONE schedule (forward or backward)."""

    schedule: str
    measured: Measurement
    model_latency_s: float
    model_bytes: float
    edges: int
    tiles: int

    @property
    def residual(self) -> float:
        """measured p50 / model-predicted latency.  1.0 = the analytical
        model is calibrated for this schedule; the tuner's measured stage
        uses the residual to know when predictions can be trusted."""
        return (self.measured.p50 / self.model_latency_s
                if self.model_latency_s > 0 else float("nan"))

    @property
    def achieved_bytes_per_s(self) -> float:
        """Modeled device-memory traffic moved per measured second."""
        p50 = self.measured.p50
        return self.model_bytes / p50 if p50 > 0 else float("nan")

    @property
    def achieved_edges_per_s(self) -> float:
        p50 = self.measured.p50
        return self.edges / p50 if p50 > 0 else float("nan")

    def to_row(self) -> dict:
        return {
            "schedule": self.schedule,
            "model_latency_us": self.model_latency_s * 1e6,
            "model_bytes": self.model_bytes,
            "residual": self.residual,
            "achieved_bytes_per_s": self.achieved_bytes_per_s,
            "achieved_edges_per_s": self.achieved_edges_per_s,
            **self.measured.to_row(),
        }


@dataclasses.dataclass(frozen=True)
class ProfileReport:
    """All schedules of one plan, plus the combined total for attribution."""

    schedules: tuple
    total: Measurement
    dim: int
    backend: str

    def attribution(self, device: bool = False) -> dict:
        """Per-schedule p50 seconds (``device``: the device-only p50s, on
        the card).  Shard rows (``profile_plan(shards=)``) measure the
        same work differently partitioned, so they are EXCLUDED from the
        sum-to-total identity."""
        return {s.schedule: (s.measured.device_p50 if device
                             else s.measured.p50)
                for s in self.schedules if "shard" not in s.schedule}

    def attribution_error(self, device: bool = False) -> float:
        """|sum(per-schedule p50) - total p50| / total p50.  Small by
        construction (the total runs the same calls back to back), large
        only when measurement noise swamps the kernels — the signal to
        distrust this profile.  ``device`` compares the device-only p50s
        (on the card), which the host's load does not move."""
        total = self.total.device_p50 if device else self.total.p50
        if not total or total <= 0:
            return float("nan")
        return abs(sum(self.attribution(device).values()) - total) / total

    def to_rows(self) -> list:
        return [s.to_row() for s in self.schedules]


def profile_plan(plan, feat=None, *, backend: str = "cuda", device="cuda",
                 dim: Optional[int] = None, iters: int = 5,
                 warmup: Optional[int] = None, registry=None,
                 label: str = "", shards: Optional[int] = None,
                 seed: int = 0) -> ProfileReport:
    """Measure a `Plan`'s schedules and attribute time per schedule.

    Runs the forward executor (and, when the plan carries a backward
    partition, the transposed schedule through `kernels.ops.aggregate`
    with an all-ones cotangent) under `measure`, prices each schedule with
    the analytical `KernelModel` over its EXACT tile count, and reports
    per-schedule achieved throughput plus the measured/predicted residual.
    A combined forward+backward run gives the total that per-schedule
    attribution must sum to (`ProfileReport.attribution_error`).

    Arguments
    ---------
    plan : repro_torch.core.plan.Plan (`plan_for` output).
    feat : optional (N, D) features (numpy or tensor) in the plan's node
        order; generated from ``np.random.default_rng(seed)`` at ``dim``
        columns (default 64) when omitted, and moved to ``device`` once.
    backend : "cuda" (the hand-written kernels) | "torch" (plain versions).
    device : where the schedules and features live ("cuda" by default).
    registry : optional MetricsRegistry — every schedule lands
        ``kernel_model_residual`` / ``profile_achieved_bytes_per_s`` /
        ``profile_achieved_edges_per_s`` gauges and a
        ``profile_schedule_seconds`` histogram fed the raw samples, all
        labelled ``{schedule, variant}``.
    label : prefix for schedule names (``label=f"b{bucket}/"`` keeps one
        plan per shape bucket apart).
    shards : optional shard count: one ``shard{p}/forward`` row per
        sub-plan of ``plan.shards(shards)``, each executor run in this
        process on one device over the features zero-padded to
        ``spec.padded_nodes`` rows (what the all-gather hands a rank), as
        the reference profiles them; no collective runs.
    """
    import numpy as np
    import torch

    from repro_torch.core.aggregate import PlanExecutor
    from repro_torch.core.extractor import extract_graph_props
    from repro_torch.core.model import KernelModel
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    g = plan.graph
    cfg = plan.config
    if feat is None:
        d = dim if dim is not None else 64
        feat = np.random.default_rng(seed).standard_normal(
            (g.num_nodes, d)).astype(np.float32)
    feat_t = torch.as_tensor(feat).to(device=dev,
                                      dtype=getattr(torch, cfg.feat_dtype))
    d = int(feat_t.shape[1])

    props = plan.graph_props
    if props is None:
        props = extract_graph_props(g, detect_communities=False)
    km = KernelModel()

    def model_terms(partition):
        return km.terms(props, d, cfg, tiles=partition.num_tiles)

    fwd_fn = plan.executor(backend, dev)
    m_fwd = measure(fwd_fn, feat_t, warmup=warmup, iters=iters)
    t_fwd = model_terms(plan.partition)
    schedules = [ScheduleProfile(
        schedule=f"{label}forward", measured=m_fwd,
        model_latency_s=t_fwd["latency"], model_bytes=t_fwd["bytes"],
        edges=g.num_edges, tiles=int(plan.partition.num_tiles))]

    bwd_fn = None
    if plan.partition_bwd is not None:
        bwd_fn = PlanExecutor.from_schedule(
            plan.sched_bwd(dev), dt=cfg.dt, variant=cfg.variant,
            backend=backend, device=dev, out_dtype=cfg.feat_dtype)
        ct = torch.ones_like(feat_t)
        m_bwd = measure(bwd_fn, ct, warmup=warmup, iters=iters)
        t_bwd = model_terms(plan.partition_bwd)
        schedules.append(ScheduleProfile(
            schedule=f"{label}backward", measured=m_bwd,
            model_latency_s=t_bwd["latency"], model_bytes=t_bwd["bytes"],
            edges=g.num_edges, tiles=int(plan.partition_bwd.num_tiles)))

    # total: the SAME callables back to back inside one timed call, so its
    # structure matches the per-schedule rows and the attribution identity
    # holds up to noise.  It waits for nothing itself (`measure` waits
    # after each wall sample): a wait inside would put the host's wake-up
    # into the total's device-only samples, and the two schedules queue
    # back to back, so those samples hold their device time alone
    if bwd_fn is not None:
        def total_call(x):
            return bwd_fn(fwd_fn(x))
    else:
        total_call = fwd_fn
    m_total = measure(total_call, feat_t, warmup=warmup, iters=iters)

    if shards:
        sub_plans = plan.shards(shards)
        spec = sub_plans.spec
        feat_pad = torch.nn.functional.pad(
            feat_t, (0, 0, 0, spec.padded_nodes - feat_t.shape[0]))
        for p_idx, sub in enumerate(sub_plans.plans):
            m_sub = measure(sub.executor(backend, dev), feat_pad,
                            warmup=warmup, iters=iters)
            t_sub = model_terms(sub.partition)
            lo, hi = sub_plans.edge_ranges[p_idx]
            schedules.append(ScheduleProfile(
                schedule=f"{label}shard{p_idx}/forward", measured=m_sub,
                model_latency_s=t_sub["latency"], model_bytes=t_sub["bytes"],
                edges=int(hi - lo), tiles=int(sub.partition.num_tiles)))

    report = ProfileReport(schedules=tuple(schedules), total=m_total,
                           dim=d, backend=backend)
    if registry is not None:
        # the variant label keeps residuals / achieved bytes attributable
        # per gather kernel, so a measured selector flipping a plan from
        # folded to direct does not silently re-base a gauge
        variant = str(cfg.variant)
        for s in schedules:
            lbl = {"schedule": s.schedule, "variant": variant}
            registry.gauge(
                "kernel_model_residual", labels=lbl,
                desc="measured p50 / KernelModel-predicted latency",
            ).set(s.residual)
            registry.gauge(
                "profile_achieved_bytes_per_s", labels=lbl,
                desc="modeled DMA bytes moved per measured second",
            ).set(s.achieved_bytes_per_s)
            registry.gauge(
                "profile_achieved_edges_per_s", labels=lbl,
                desc="edges aggregated per measured second",
            ).set(s.achieved_edges_per_s)
            h = registry.histogram(
                "profile_schedule_seconds", labels=lbl,
                desc="measured per-call wall time (repro.obs.profile)")
            for x in s.measured.samples:
                h.observe(x)
    return report
