"""Shared arithmetic of the readers that take a metric from the traced
window (`perfbench.devtrace.TraceSummary`); a reader with no trace, or
with nothing of its kind in it, returns None."""
from __future__ import annotations

import pathlib
from typing import List, Optional

from perfbench.metrics import _peaks, _work

AGG_PATTERNS = pathlib.Path(__file__).resolve().parent / "agg_kernels"


def agg_patterns() -> List[str]:
    """Substrings naming the aggregation kernels: one per line of every
    ``agg_kernels/*.txt`` (``#`` starts a comment)."""
    pats = []
    for f in sorted(AGG_PATTERNS.glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                pats.append(line)
    return pats


def _is_agg(name: str, pats: List[str]) -> bool:
    return any(p in name for p in pats)


def _kind(run) -> str:
    return run.mix["kind"]


def launches(run) -> Optional[float]:
    t = run.trace
    if t is None or not t.units or not t.kernels:
        return None
    return sum(c for c, _ in t.kernels.values()) / t.units


def agg_seconds(run) -> Optional[float]:
    """Aggregation kernels' device seconds a unit (step or request)."""
    t = run.trace
    if t is None or not t.units:
        return None
    pats = agg_patterns()
    s = sum(sec for k, (_, sec) in t.kernels.items() if _is_agg(k, pats))
    return s / t.units if s > 0 else None


def agg_ms(run) -> Optional[float]:
    s = agg_seconds(run)
    return None if s is None else s * 1e3


def dense_ms(run) -> Optional[float]:
    t = run.trace
    if t is None or not t.units:
        return None
    pats = agg_patterns()
    s = sum(sec for k, (_, sec) in t.kernels.items() if not _is_agg(k, pats))
    s += t.other_s
    return s / t.units * 1e3 if s > 0 else None


def agg_roofline(run) -> Optional[float]:
    s = agg_seconds(run)
    if s is None:
        return None
    calls = _work.agg_calls(run.arch, run.config["model"], run.graph,
                            _kind(run))
    return 100.0 * _work.agg_least_seconds(calls) / s


def mfu(run) -> Optional[float]:
    t = run.trace
    if t is None or not t.units or t.window_s <= 0:
        return None
    flops = _work.model_flops(run.arch, run.config["model"], run.graph,
                              _kind(run))
    return 100.0 * flops / (t.window_s / t.units * _peaks.F32_FLOP_PER_S)


def idle_pct(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
