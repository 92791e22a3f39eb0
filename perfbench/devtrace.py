"""The traced stretch of a ``--trace 1`` run: `torch.profiler` over the
first seconds of the measured window, reduced to what the per-layer
readers take (device time by kernel, busy time, the window's length, the
idle gaps labelled by the host op that was running).

Time base: the profiler's own clock for everything, the window being the
benchmark's ``bench.window`` range, closed after a synchronise.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["TraceSummary", "TracedWindow"]

WINDOW = "bench.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float                     # the traced window's length
    busy_s: float                       # union of device ops inside it
    units: int                          # steps or requests it completed
    kernels: Dict[str, Tuple[int, float]]   # name -> (launches, seconds)
    other_s: float                      # memcpy and memset seconds
    idle_gaps: List[Tuple[str, float]]  # host op -> idle seconds, longest first

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The kernels with the most device seconds, by short name."""
        by: Dict[str, float] = defaultdict(float)
        for k, (_, s) in self.kernels.items():
            by[short_name(k)] += s
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:200]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def summarize(events, units: int) -> TraceSummary:
    """Reduce `profile.events()` to a `TraceSummary` (times in µs in the
    events, seconds in the summary)."""
    cpu = torch.autograd.DeviceType.CPU
    win = [e for e in events if e.name == WINDOW and e.device_type == cpu]
    if len(win) != 1:
        raise RuntimeError(f"expected one {WINDOW} range, found {len(win)}")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a range's mirror on the device timeline is no device op
            if getattr(e, "is_user_annotation", False) or e.name == WINDOW:
                continue
            if t1 > w0 and t0 < w1:
                dev.append((max(t0, w0), min(t1, w1), e.name))
        elif e.name != WINDOW and t1 > t0:
            host.append((t0, t1, e.name))
    dev.sort()
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    other = 0.0
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    edge = w0
    for t0, t1, name in dev:
        if _is_copy(name):
            other += t1 - t0
        else:
            kernels[name][0] += 1
            kernels[name][1] += t1 - t0
        if t0 > edge:
            gaps.append((edge, t0))
        if t1 > edge:
            busy += t1 - max(t0, edge)
            edge = t1
    if w1 > edge:
        gaps.append((edge, w1))
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, units=units,
        kernels={k: (int(c), s * 1e-6) for k, (c, s) in kernels.items()},
        other_s=other * 1e-6, idle_gaps=_label(gaps, host))


def _label(gaps, host, top: int = 10) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost host op running at each
    gap's midpoint (the latest-starting op that contains it)."""
    host.sort()
    starts = [h[0] for h in host]
    by: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "no host op"
        for j in range(i, max(i - 4096, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by[name] += (g1 - g0) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


class TracedWindow:
    """`prepare()` at the end of set-up (the profiler's own start-up, some
    seconds, stays out of the window), `start()` at the window's start,
    `stop(units)` once the traced stretch is over; a no-op when tracing
    is off."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.summary: Optional[TraceSummary] = None
        self._prof = self._range = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare(self):
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._sync()

    def start(self):
        if not self.enabled:
            return
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    @property
    def active(self) -> bool:
        return self._prof is not None and self.summary is None

    def stop(self, units: int):
        if not self.active:
            return
        self._sync()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.summary = summarize(self._prof.events(), units)
        self._prof = None
