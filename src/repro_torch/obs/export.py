"""Exporters: one registry -> JSON document or Prometheus exposition text.

Port of `src/repro/obs/export.py` (the exporters, the exposition lint
and the label-value unescaping, carried over verbatim).

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
in label VALUES, which Prometheus allows verbatim.  `lint_prometheus`
checks exactly the invariants scrapers rely on.
"""
from __future__ import annotations

import json
import math
import re
from datetime import datetime, timezone
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["lint_prometheus", "registry_to_json", "to_prometheus_text",
           "unescape_label_value", "write_metrics"]

_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (NaN|[-+]?Inf|"
    r"[-+]?[0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?)$")
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
    two); `lint_prometheus` rejects unescaped output."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def unescape_label_value(v: str) -> str:
    """Inverse of the exposition-format escaping (round-trip tests)."""
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


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


_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_:]*)="((?:[^"\\\n]|\\["\\n])*)"')


def _lint_labels(blob: str):
    """Problem string when a ``{...}`` label blob is not a comma-joined
    sequence of ``name="value"`` pairs with fully escaped values (raw
    ``\\``, ``"`` or newline inside a value breaks scrapers)."""
    s = blob[1:-1]
    i, first = 0, True
    while i < len(s):
        if not first:
            if s[i] != ",":
                return f"expected ',' in labels at offset {i}: {s[i:i+20]!r}"
            i += 1
        m = _LABEL_PAIR.match(s, i)
        if m is None:
            return (f"unparseable or unescaped label pair at offset {i}: "
                    f"{s[i:i+20]!r}")
        i = m.end()
        first = False
    return None


# the ``le`` label as a whole name: the reference's pattern also matched
# the tail of a name such as ``schedule``, merging every series of a
# histogram labelled by it into one and reporting them as not cumulative
_LE = r'(?<![a-zA-Z0-9_:])le="([^"]*)"'


def _strip_le(labels: str) -> str:
    """Label string minus the ``le`` pair, normalized so bucket and
    _sum/_count series of the same histogram compare equal."""
    s = re.sub(_LE + ",?", "", labels).replace(",}", "}")
    return "" if s in ("{}", "") else s


def lint_prometheus(text: str) -> list:
    """Minimal exposition-format lint; returns a list of problems (empty =
    clean).  Checks the invariants scrapers actually depend on:

      * every sample line parses as ``name[{labels}] value``;
      * label blobs are comma-joined ``name="value"`` pairs whose values
        carry no unescaped ``\\``, ``"`` or newline;
      * every sample's base name has a preceding ``# TYPE``;
      * histogram series carry a ``+Inf`` bucket whose value equals
        ``_count``, and bucket counts are cumulative (non-decreasing).
    """
    problems = []
    types: dict = {}
    hist: dict = {}     # (base, labels-sans-le) -> [(le, v)], for cum check
    hist_count: dict = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE.match(line)
        if m is None:
            problems.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name, labels = m.group(1), m.group(2) or ""
        if labels:
            lp = _lint_labels(labels)
            if lp is not None:
                problems.append(f"line {i}: {lp}")
        base = name
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and name[: -len(suf)] in types:
                base = name[: -len(suf)]
                break
        if base not in types:
            problems.append(f"line {i}: sample {name!r} has no # TYPE")
            continue
        if types[base] == "histogram" and name == base + "_bucket":
            le = re.search(_LE, labels)
            if le is None:
                problems.append(f"line {i}: histogram bucket without le=")
                continue
            key = (base, _strip_le(labels))
            hist.setdefault(key, []).append(
                (float(le.group(1).replace("+Inf", "inf")),
                 float(m.group(3))))
        if types[base] == "histogram" and name == base + "_count":
            key = (base, _strip_le(labels))
            hist_count[key] = float(m.group(3))
    for key, buckets in hist.items():
        buckets.sort()
        if not buckets or not math.isinf(buckets[-1][0]):
            problems.append(f"histogram {key[0]}{key[1]}: no +Inf bucket")
            continue
        vals = [v for _, v in buckets]
        if any(b > a for a, b in zip(vals[1:], vals)):
            problems.append(f"histogram {key[0]}{key[1]}: buckets are not "
                            f"cumulative")
        cnt = hist_count.get(key)
        if cnt is not None and cnt != vals[-1]:
            problems.append(f"histogram {key[0]}{key[1]}: _count={cnt} != "
                            f"+Inf bucket {vals[-1]}")
    return problems
