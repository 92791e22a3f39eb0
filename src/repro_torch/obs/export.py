"""Exporters: one registry -> JSON document or Prometheus exposition text.

Port of `src/repro/obs/export.py` (the exporters, carried over verbatim;
the exposition lint stays with the reference's tooling).

Both render the SAME `MetricsRegistry.snapshot()`, so the CLI's printed
metrics, ``--metrics-out`` files and benchmark-derived percentiles agree by
construction (the tentpole invariant of docs/observability.md).

JSON document shape::

    {"schema": "repro.obs/v1", "generated_at": "<iso8601>",
     "context": {...optional...},
     "metrics": [ {"name", "type", "labels", ...state...}, ... ],
     "spans":   [ {"span", "t_rel_s", "duration_s"}, ... ]}

Prometheus text follows the exposition format 0.0.4: ``# HELP``/``# TYPE``
headers, histograms as cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``.  Metric names are sanitized to the legal charset
(``[a-zA-Z_:][a-zA-Z0-9_:]*``); free-form internal names (span paths) ride
in label VALUES, which Prometheus allows verbatim.
"""
from __future__ import annotations

import json
import math
import re
from datetime import datetime, timezone
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["registry_to_json", "to_prometheus_text", "write_metrics"]

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _sanitize(name: str) -> str:
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return s if _NAME_OK.match(s) else "_" + s


def _fmt(v: float) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _escape_label_value(v) -> str:
    """Exposition-format label-value escaping: backslash, double-quote and
    newline — the three characters scrapers require escaped.  Anything
    less corrupts line-based parsers (a raw newline splits the sample in
    two)."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _label_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = {**labels, **(extra or {})}
    if not items:
        return ""
    return ("{" + ",".join(f'{_sanitize(k)}="{_escape_label_value(v)}"'
                           for k, v in sorted(items.items())) + "}")


def registry_to_json(registry: MetricsRegistry, *, tracer=None,
                     context: Optional[dict] = None) -> dict:
    """JSON-able document for the whole registry (+ optional span trace)."""
    doc = {
        "schema": "repro.obs/v1",
        "generated_at": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "metrics": registry.snapshot(),
    }
    if context:
        doc["context"] = dict(context)
    if tracer is not None:
        doc["spans"] = tracer.records()
    return doc


def to_prometheus_text(registry: MetricsRegistry) -> str:
    """Exposition-format 0.0.4 text for the whole registry."""
    by_name: dict = {}
    for m in registry.metrics():
        by_name.setdefault(_sanitize(m.name), []).append(m)
    lines = []
    for name in sorted(by_name):
        group = by_name[name]
        kind = group[0].kind
        desc = next((g.desc for g in group if g.desc), "")
        if desc:
            lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {kind}")
        for m in sorted(group, key=lambda m: m.labels):
            labels = dict(m.labels)
            if kind in ("counter", "gauge"):
                lines.append(f"{name}{_label_str(labels)} {_fmt(m.value)}")
            else:
                for le, cum in m.cumulative_buckets():
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(labels, {'le': _fmt(le)})} {cum}")
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_fmt(m.sum)}")
                lines.append(f"{name}_count{_label_str(labels)} {m.count}")
    return "\n".join(lines) + "\n"


def write_metrics(registry: MetricsRegistry, path: str, fmt: str = "json",
                  *, tracer=None, context: Optional[dict] = None) -> None:
    """Write the registry to ``path`` as ``fmt`` ("json" | "prom")."""
    if fmt == "json":
        with open(path, "w") as f:
            json.dump(registry_to_json(registry, tracer=tracer,
                                       context=context), f, indent=1)
            f.write("\n")
    elif fmt == "prom":
        with open(path, "w") as f:
            f.write(to_prometheus_text(registry))
    else:
        raise ValueError(f"unknown metrics format {fmt!r} "
                         f"(expected 'json' or 'prom')")

