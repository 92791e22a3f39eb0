"""GNN serving: the synchronous tier (micro-batcher, plan cache,
`ServingEngine`) and the async SLO-aware tier (admission, deadline and
clock batching, EDF across tenants, `AsyncServingEngine`).

Port of `src/repro/serving/`, with sharded serving
(`make_sharded_serve_fn`) over a rank group.
"""
from repro_torch.serving.admission import (AdmissionQueue, AsyncRequest,
                                           SLOClass, slo_classes)
from repro_torch.serving.batcher import (ClockBatcher, DeadlineBatcher,
                                         MicroBatcher, Request)
from repro_torch.serving.engine import (AsyncServingEngine, ServingConfig,
                                        ServingEngine, TenantSpec,
                                        make_sharded_serve_fn)
from repro_torch.serving.loadgen import (Arrival, LoadSpec, build_schedule,
                                         run_schedule, zipf_seeds)
from repro_torch.serving.plan_cache import (CacheEntry, PlanCache,
                                            bucket_pow2, graph_key,
                                            shape_class_fingerprint)

__all__ = ["AdmissionQueue", "Arrival", "AsyncRequest", "AsyncServingEngine",
           "CacheEntry", "ClockBatcher", "DeadlineBatcher", "LoadSpec",
           "MicroBatcher", "PlanCache", "Request", "SLOClass",
           "ServingConfig", "ServingEngine", "TenantSpec", "bucket_pow2",
           "build_schedule", "graph_key", "make_sharded_serve_fn",
           "run_schedule", "shape_class_fingerprint", "slo_classes",
           "zipf_seeds"]
