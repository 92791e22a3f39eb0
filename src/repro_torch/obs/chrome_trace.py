"""Chrome/Perfetto trace export for `SpanTracer` records.

Port of `src/repro/obs/chrome_trace.py` (stdlib only, kept as the port's
own copy); the process track is named ``repro_torch``.

Renders the tracer's ring-buffer records as a Chrome Trace Event Format
document (the ``traceEvents`` JSON that chrome://tracing and
https://ui.perfetto.dev open directly).  Every span becomes one complete
("ph": "X") event: name = the "/"-joined span path, timestamps in
microseconds relative to the tracer's epoch, thread track = the recording
thread (records carry ``tid``/``thread`` — see `repro_torch.obs.trace`).
Perfetto nests same-track events by time containment, so the span
hierarchy renders as a flame chart without any extra bookkeeping.

Surfaced as ``--trace-out PATH`` on `repro_torch.launch.train` and
`repro_torch.launch.serve_gnn`.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

__all__ = ["chrome_trace_doc", "write_chrome_trace"]

_PID = 0


def _events(records: Sequence[dict]) -> list:
    events = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": "repro_torch"},
    }]
    named_tids = set()
    for rec in records:
        tid = int(rec.get("tid", 0))
        if tid not in named_tids and rec.get("thread"):
            named_tids.add(tid)
            events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                           "tid": tid, "args": {"name": rec["thread"]}})
    for rec in sorted(records, key=lambda r: r.get("t_rel_s", 0.0)):
        events.append({
            "name": rec["span"],
            "cat": "span",
            "ph": "X",
            "ts": round(rec.get("t_rel_s", 0.0) * 1e6, 3),
            "dur": round(rec.get("duration_s", 0.0) * 1e6, 3),
            "pid": _PID,
            "tid": int(rec.get("tid", 0)),
            "args": dict(rec.get("attrs", {})),
        })
    return events


def chrome_trace_doc(tracer=None, *, records: Optional[Sequence[dict]] = None,
                     context: Optional[dict] = None) -> dict:
    """Chrome Trace Event Format document for a tracer (or raw records).

    Pass either a `SpanTracer` or its ``records()`` list.  ``context``
    (normally `repro_torch.obs.run_context()`) rides in ``otherData`` so
    the trace stays attributable to a git SHA / device like every other
    artifact this repo emits.
    """
    if records is None:
        if tracer is None:
            raise ValueError("chrome_trace_doc needs a tracer or records")
        records = tracer.records()
    doc = {
        "traceEvents": _events(records),
        "displayTimeUnit": "ms",
    }
    if context:
        doc["otherData"] = dict(context)
    return doc


def write_chrome_trace(path: str, tracer=None, *,
                       records: Optional[Sequence[dict]] = None,
                       context: Optional[dict] = None) -> None:
    """Write the Chrome-trace JSON to ``path`` (open in ui.perfetto.dev)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace_doc(tracer, records=records, context=context),
                  f, indent=1)
        f.write("\n")
