"""Synchronous GNN serving: micro-batcher, plan cache, serving engine.

Port of the synchronous tier of `src/repro/serving/`; the async SLO-aware
tier (admission, deadline batching, sharded serving) waits for its slice.
"""
from repro_torch.serving.batcher import MicroBatcher, Request
from repro_torch.serving.engine import ServingConfig, ServingEngine
from repro_torch.serving.loadgen import zipf_seeds
from repro_torch.serving.plan_cache import (CacheEntry, PlanCache,
                                            bucket_pow2, graph_key,
                                            shape_class_fingerprint)

__all__ = ["CacheEntry", "MicroBatcher", "PlanCache", "Request",
           "ServingConfig", "ServingEngine", "bucket_pow2", "graph_key",
           "shape_class_fingerprint", "zipf_seeds"]
