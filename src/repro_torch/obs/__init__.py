"""Runtime observability: metrics, spans, exporters, the profiling tier.

Port of `src/repro/obs/`.  One `MetricsRegistry` threaded through the
serving engines, plan cache, sampled loader and trainer; a `SpanTracer`
for nested wall-clock spans that synchronize with the card on close;
JSON / Prometheus exporters that render the same registry (with the
exposition lint); a Chrome/Perfetto trace exporter over the tracer's
records (``--trace-out`` on both drivers); the measurement harness
(`measure` / `profile_plan`: wall and device-only samples, per-schedule
residuals against `KernelModel`); and the persisted perf-baseline layer
(`obs.baseline`) that the port's benchmarks will compare against.
"""
from repro_torch.obs.baseline import (BASELINE_SCHEMA, append_history,
                                      compare_rows, load_baseline,
                                      make_baseline, row_tolerance,
                                      save_baseline, validate_baseline)
from repro_torch.obs.chrome_trace import chrome_trace_doc, write_chrome_trace
from repro_torch.obs.context import run_context
from repro_torch.obs.export import (lint_prometheus, registry_to_json,
                                    to_prometheus_text, unescape_label_value,
                                    write_metrics)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, exponential_bounds,
                                     pow2_bounds)
from repro_torch.obs.profile import (Measurement, ProfileReport,
                                     ScheduleProfile, measure, profile_plan)
from repro_torch.obs.trace import Span, SpanTracer

__all__ = [
    "BASELINE_SCHEMA",
    "Counter",
    "Gauge",
    "Histogram",
    "Measurement",
    "MetricsRegistry",
    "ProfileReport",
    "ScheduleProfile",
    "Span",
    "SpanTracer",
    "append_history",
    "chrome_trace_doc",
    "compare_rows",
    "exponential_bounds",
    "lint_prometheus",
    "load_baseline",
    "make_baseline",
    "measure",
    "pow2_bounds",
    "profile_plan",
    "registry_to_json",
    "row_tolerance",
    "run_context",
    "save_baseline",
    "to_prometheus_text",
    "unescape_label_value",
    "validate_baseline",
    "write_chrome_trace",
    "write_metrics",
]
