"""Persisted perf baselines + noise-aware regression comparison.

Port of `src/repro/obs/baseline.py` (stdlib only, kept as the port's own
copy; the schema name is the reference's, so documents of either package
validate in the other).  The port has no benchmark or comparator CLI yet
(ROADMAP Queue 1 item 8); this is the layer they will be made of.

A baseline document (schema ``repro.bench_baseline/v1``) pins one
benchmark section's rows (each a ``name`` and a ``us_per_call``) to a
known-good measurement, stamped with `run_context()` provenance, and
accumulates a ``history`` list (one summary entry per update), so a
benchmark keeps its perf trajectory instead of discarding every run.

Comparison is NOISE-AWARE: rows measured through the `obs.profile`
harness carry their own p50/p90 spread (`Measurement.to_row`), and each
row's relative tolerance is derived from the LARGER of the baseline's and
the current run's recorded spread, scaled by ``noise_factor`` and floored
at ``rel_floor`` — a metric that jitters 30% run-to-run cannot produce a
20% "regression".  Verdicts are explicit per row:

  ``improve``  current < baseline * (1 - tol)
  ``flat``     within tolerance
  ``regress``  current > baseline * (1 + tol)
  ``missing``  baseline row absent from the current run (stale baseline or
               dropped metric — update the baseline deliberately)
  ``new``      current row with no baseline yet (informational)
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

__all__ = ["BASELINE_SCHEMA", "append_history", "compare_rows",
           "load_baseline", "make_baseline", "row_tolerance",
           "save_baseline", "validate_baseline"]

BASELINE_SCHEMA = "repro.bench_baseline/v1"

# rows without a recorded p50/p90 spread (derived-only rows, subprocess
# re-emits) fall back to this relative tolerance before the floor applies
_NO_SPREAD_REL = 0.25


def make_baseline(section: str, rows: Sequence[dict], *,
                  context: Optional[dict] = None,
                  history: Sequence[dict] = ()) -> dict:
    """Fresh baseline document for one bench section's rows."""
    return {
        "schema": BASELINE_SCHEMA,
        "section": section,
        "context": dict(context or {}),
        "rows": [dict(r) for r in rows],
        "history": [dict(h) for h in history],
    }


def validate_baseline(doc, path: str = "") -> list:
    """Schema problems (empty list = valid).  Schema problems are always a
    HARD failure in the CI gate — a malformed baseline silently compares
    nothing."""
    where = path or "<baseline>"
    if not isinstance(doc, dict):
        return [f"{where}: not a JSON object"]
    problems = []
    if doc.get("schema") != BASELINE_SCHEMA:
        problems.append(f"{where}: schema != {BASELINE_SCHEMA} "
                        f"(got {doc.get('schema')!r})")
    if not doc.get("section"):
        problems.append(f"{where}: missing 'section'")
    rows = doc.get("rows")
    if not isinstance(rows, list) or not rows:
        problems.append(f"{where}: empty or missing 'rows' list")
        return problems
    for i, r in enumerate(rows):
        if not isinstance(r, dict) or "name" not in r:
            problems.append(f"{where}: rows[{i}] missing 'name'")
            continue
        us = r.get("us_per_call")
        if not isinstance(us, (int, float)):
            problems.append(f"{where}: rows[{i}] ({r['name']}) missing "
                            f"numeric 'us_per_call'")
    if not isinstance(doc.get("history", []), list):
        problems.append(f"{where}: 'history' is not a list")
    if "context" in doc and not doc["context"].get("git_sha"):
        problems.append(f"{where}: context present but git_sha empty")
    return problems


def _spread(row: dict) -> Optional[float]:
    p50, p90 = row.get("p50_us"), row.get("p90_us")
    if isinstance(p50, (int, float)) and isinstance(p90, (int, float)) \
            and p50 > 0 and p90 >= p50:
        return (p90 - p50) / p50
    return None


def row_tolerance(base_row: dict, cur_row: Optional[dict] = None, *,
                  rel_floor: float = 0.10,
                  noise_factor: float = 3.0) -> float:
    """Relative tolerance for one row: ``noise_factor`` times the larger of
    the two runs' recorded (p90-p50)/p50 spreads, floored at ``rel_floor``;
    rows with no recorded spread fall back to a generous constant."""
    spreads = [s for s in (_spread(base_row),
                           _spread(cur_row) if cur_row else None)
               if s is not None]
    if not spreads:
        return max(rel_floor, _NO_SPREAD_REL)
    return max(rel_floor, noise_factor * max(spreads))


def compare_rows(base_rows: Sequence[dict], cur_rows: Sequence[dict], *,
                 rel_floor: float = 0.10,
                 noise_factor: float = 3.0) -> list:
    """Per-row verdicts (see module docstring for the vocabulary).

    Rows match by ``name``; ``us_per_call`` is the compared metric (lower
    is better — every emit row is latency-shaped by the CSV contract)."""
    cur_by_name = {r.get("name"): r for r in cur_rows}
    out = []
    seen = set()
    for b in base_rows:
        name = b.get("name")
        seen.add(name)
        c = cur_by_name.get(name)
        if c is None:
            out.append({"name": name, "verdict": "missing",
                        "base_us": b.get("us_per_call"), "cur_us": None,
                        "ratio": None, "tol_rel": None})
            continue
        base_us, cur_us = float(b["us_per_call"]), float(c["us_per_call"])
        tol = row_tolerance(b, c, rel_floor=rel_floor,
                            noise_factor=noise_factor)
        if base_us <= 0:
            verdict = "flat"       # non-latency/zero rows cannot regress
            ratio = None
        else:
            ratio = cur_us / base_us
            verdict = ("regress" if ratio > 1.0 + tol
                       else "improve" if ratio < 1.0 - tol else "flat")
        out.append({"name": name, "verdict": verdict, "base_us": base_us,
                    "cur_us": cur_us, "ratio": ratio, "tol_rel": tol})
    for c in cur_rows:
        if c.get("name") not in seen:
            out.append({"name": c.get("name"), "verdict": "new",
                        "base_us": None, "cur_us": c.get("us_per_call"),
                        "ratio": None, "tol_rel": None})
    return out


def append_history(doc: dict, rows: Sequence[dict],
                   context: Optional[dict] = None, *,
                   max_history: int = 50) -> dict:
    """Append a compact trajectory entry (name -> us_per_call) for the new
    measurement and install the rows as the current baseline.  History is
    bounded: oldest entries drop past ``max_history``."""
    entry = {
        "git_sha": (context or {}).get("git_sha", "unknown"),
        "timestamp": (context or {}).get("timestamp", ""),
        "rows": {r["name"]: r.get("us_per_call") for r in rows
                 if "name" in r},
    }
    history = list(doc.get("history", [])) + [entry]
    doc["history"] = history[-max_history:]
    doc["rows"] = [dict(r) for r in rows]
    if context:
        doc["context"] = dict(context)
    return doc


def load_baseline(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def save_baseline(doc: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
