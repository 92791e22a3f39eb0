"""Runtime observability: metrics registry, span tracer, JSON exporter.

Port of the framework-free part of `src/repro/obs/`; the profiling tier
(`profile.py`, Chrome-trace export, perf baselines) waits for a later slice.
"""
from repro_torch.obs.context import run_context
from repro_torch.obs.export import (registry_to_json, to_prometheus_text,
                                    write_metrics)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, exponential_bounds,
                                     pow2_bounds)
from repro_torch.obs.trace import Span, SpanTracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
           "SpanTracer", "exponential_bounds", "pow2_bounds", "registry_to_json", "run_context",
           "to_prometheus_text", "write_metrics"]
