"""Serving engine: node-level GNN prediction against a resident graph.

Port of `ServingEngine` from `src/repro/serving/engine.py` (:104-:443),
the synchronous, thread-free micro-batching engine (callers drive the
clock explicitly):

    submit(seed) -> MicroBatcher -> k-hop ego-graph union (or disjoint
    union) -> shape bucketing -> PlanCache (advisor config + partition +
    device schedule reuse) -> batched aggregation kernels -> per-seed
    logits.

PyTorch runs eagerly, so the reference's jit cache has no counterpart:
a cache entry's forward is the model's plain `logits`.  Features ship
host -> device per batch at the policy dtype, and the ``compute`` span
synchronizes the device so it times the device work.

GCN edge values are computed ONCE from the resident graph's degrees and
sliced into every subgraph, so batched ego inference is numerically
identical to full-graph inference at the seeds.  The async tier,
sharded serving and graph mutation wait for their slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device, set_matmul_precision
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.subgraph import batch_egos, extract_ego, pad_to_nodes
from repro_torch.models.gnn import (GNNConfig, GNNModel, gcn_edge_values,
                                    init_gnn_params)
from repro_torch.obs import MetricsRegistry, SpanTracer, pow2_bounds
from repro_torch.serving.batcher import MicroBatcher, Request
from repro_torch.serving.plan_cache import PlanCache, bucket_pow2

__all__ = ["ServingConfig", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    hops: Optional[int] = None      # ego-graph radius; default = num_layers
    max_batch: int = 16             # micro-batch size budget
    max_wait: Optional[float] = None  # seconds; None = size-only batching
    batch_mode: str = "union"       # "union" | "disjoint"
    bucket_shapes: bool = True      # pad node/tile counts to powers of two
    tune_mode: str = "model"
    tune_iters: int = 6
    max_plans: Optional[int] = 64   # plan-level LRU bound (None = unbounded)
    max_configs: Optional[int] = None  # config-memo LRU bound
    variant: str = "folded"         # gather kernel of every plan (port knob)


class _EngineStats:
    """Registry-backed, bounded engine metrics (fixed-bucket histograms
    and counters in the engine's `MetricsRegistry`)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.latency = registry.histogram(
            "serve_request_latency_seconds",
            desc="submit -> result request latency")
        self.queue_wait = registry.histogram(
            "serve_queue_wait_seconds",
            desc="submit -> micro-batch-fire queue wait")
        self.compute = registry.histogram(
            "serve_batch_compute_seconds",
            desc="extract + plan + forward wall time per fired batch")
        self.batch_size = registry.histogram(
            "serve_batch_size", unit="", bounds=pow2_bounds(4096),
            desc="requests per fired micro-batch")
        self.sub_nodes = registry.histogram(
            "serve_batch_sub_nodes", unit="", bounds=pow2_bounds(1 << 22),
            desc="unpadded subgraph node count per fired batch")
        self.requests = registry.counter(
            "serve_requests_total", desc="completed micro-batched requests")
        self.batches = registry.counter(
            "serve_batches_total", desc="fired micro-batches")
        self.t_first_submit: Optional[float] = None
        self.t_last_done: Optional[float] = None


class ServingEngine:
    """Front door: owns the resident graph, features, weights, batcher and
    plan cache.  Thread-free; callers may drive time explicitly (`now=`).

    graph : CSRGraph — resident graph, aggregation direction dst<-src.
    feat : (num_nodes, cfg.in_dim) float32 — resident node features, kept
        on the host; each batch ships its rows to ``cfg.device``.
    cfg : GNNConfig — architecture, backend ("cuda" kernels or "torch"
        plain versions), dtype policy and device.
    params : optional parameter dict on ``cfg.device`` (default: a fresh
        `init_gnn_params` from ``generator``, seed 0 when None).
    serving : ServingConfig — batching/bucketing/tuner knobs.
    registry / tracer / cache : optional shared observability sinks and
        plan cache.

    API: `serve_batch(seeds) -> (len(seeds), num_classes) float32 numpy
    logits`; `submit()`/`step()` for micro-batched request flow;
    `run_trace(seeds)` to replay a trace; `summary()` for metrics.

    >>> eng = ServingEngine(g, feat, GNNConfig(arch="gcn", in_dim=64))
    >>> logits = eng.serve_batch([17, 42])          # (2, num_classes)
    """

    def __init__(self, graph: CSRGraph, feat: np.ndarray, cfg: GNNConfig, *,
                 params=None, generator: Optional[torch.Generator] = None,
                 serving: Optional[ServingConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 cache: Optional[PlanCache] = None,
                 tracer: Optional[SpanTracer] = None):
        if feat.shape != (graph.num_nodes, cfg.in_dim):
            raise ValueError(f"feat shape {feat.shape} != "
                             f"({graph.num_nodes}, {cfg.in_dim})")
        self.device = resolve_device(cfg.device)
        set_matmul_precision()
        self.graph = graph
        self.feat = np.ascontiguousarray(feat, dtype=np.float32)
        self.cfg = cfg
        self.serving = serving or ServingConfig()
        self.hops = self.serving.hops or cfg.num_layers
        self.params = (params if params is not None
                       else init_gnn_params(cfg, generator))
        if cfg.arch == "gcn":
            self.src_graph, self.src_vals = gcn_edge_values(graph)
        else:
            self.src_graph, self.src_vals = graph, None
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace = tracer if tracer is not None else SpanTracer(self.registry)
        if cache is not None:
            if (cache.feat_dtype != cfg.feat_dtype or cache.backend != cfg.backend
                    or resolve_device(cache.device) != self.device):
                raise ValueError(
                    f"shared PlanCache policy mismatch: cache has "
                    f"(backend={cache.backend}, feat_dtype={cache.feat_dtype},"
                    f" device={cache.device}), engine wants ({cfg.backend}, "
                    f"{cfg.feat_dtype}, {self.device})")
            self.cache = cache
        else:
            self.cache = PlanCache(
                backend=cfg.backend, device=self.device,
                tune_mode=self.serving.tune_mode,
                tune_iters=self.serving.tune_iters,
                max_plans=self.serving.max_plans,
                max_configs=self.serving.max_configs,
                bucket_shapes=self.serving.bucket_shapes,
                feat_dtype=cfg.feat_dtype, variant=self.serving.variant,
                registry=self.registry)
        self._closed = False
        self.batcher = MicroBatcher(
            max_batch=self.serving.max_batch,
            max_wait=(np.inf if self.serving.max_wait is None
                      else self.serving.max_wait))
        self.stats = _EngineStats(self.registry)
        self._next_rid = 0

    # ---------------- synchronous batch inference ----------------

    def _extract(self, seeds: Sequence[int]):
        if self.serving.batch_mode == "disjoint" and len(seeds) > 1:
            egos = [extract_ego(self.src_graph, [s], self.hops, self.src_vals)
                    for s in seeds]
            be = batch_egos(egos)
            return be.graph, be.nodes, be.seed_local, be.edge_vals
        ego = extract_ego(self.src_graph, seeds, self.hops, self.src_vals)
        return ego.graph, ego.nodes, ego.seed_local, ego.edge_vals

    def serve_batch(self, seeds: Sequence[int]) -> np.ndarray:
        """Batched inference for `seeds` -> (len(seeds), num_classes)."""
        t0 = time.perf_counter()
        cfg = self.cfg
        with self.trace.span("serve_batch") as sb:
            with self.trace.span("extract"):
                sub, nodes, seed_local, vals = self._extract(seeds)
            n_real = sub.num_nodes
            if self.serving.bucket_shapes:
                sub = pad_to_nodes(sub, bucket_pow2(n_real))
            with self.trace.span("plan"):
                ent = self.cache.get_or_build(
                    sub, arch=cfg.arch, in_dim=cfg.in_dim,
                    hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                    edge_vals=vals)
                if ent.apply_fn is None:
                    ent.apply_fn = self._make_apply(ent)
            feat_sub = np.zeros((sub.num_nodes, cfg.in_dim), np.float32)
            feat_sub[:n_real] = self.feat[nodes]
            # ship features at the policy dtype (bf16 halves the
            # host->device bytes); block=True makes the span wait for the
            # device, so it times the work and not the enqueue
            with self.trace.span("compute", block=True) as sp:
                x = torch.from_numpy(feat_sub).to(cfg.compute_dtype)
                logits = sp.sync(ent.apply_fn(self.params, x.to(self.device)))
            out = logits.cpu().numpy()
            sb.note(batch=len(seeds), sub_nodes=n_real)
        self.stats.batches.inc()
        self.stats.batch_size.observe(len(seeds))
        self.stats.sub_nodes.observe(n_real)
        self.stats.compute.observe(time.perf_counter() - t0)
        return out[np.asarray(seed_local)]

    def _make_apply(self, ent):
        """The forward for a cache entry: the model's plain logits."""
        model = GNNModel(cfg=self.cfg, plan=ent.plan, executor=ent.executor,
                         params=self.params)
        return model.logits

    # ---------------- request API (micro-batched) ----------------

    def submit(self, seed: int, now: Optional[float] = None) -> Request:
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        now = time.perf_counter() if now is None else now
        if self.stats.t_first_submit is None:
            self.stats.t_first_submit = now
        req = Request(rid=self._next_rid, seed=int(seed), t_submit=now)
        self._next_rid += 1
        self.batcher.put(req)
        return req

    def step(self, now: Optional[float] = None, *,
             force: bool = False) -> list[Request]:
        """Fire every due micro-batch (all pending ones when `force`)."""
        done: list[Request] = []
        while True:
            t = time.perf_counter() if now is None else now
            if not (self.batcher.ready(t)
                    or (force and self.batcher.pending())):
                break
            batch = self.batcher.pop()
            t_pop = time.perf_counter() if now is None else now
            for r in batch:
                self.stats.queue_wait.observe(max(t_pop - r.t_submit, 0.0))
            out = self.serve_batch([r.seed for r in batch])
            t_done = time.perf_counter() if now is None else now
            for i, r in enumerate(batch):
                r.result = out[i]
                r.t_done = t_done
                r.status = "done"
                self.stats.latency.observe(r.latency)
                self.stats.requests.inc()
            self.stats.t_last_done = t_done
            done.extend(batch)
        return done

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Shut down: ``drain=True`` fires forced batches until the queue is
        empty or ``timeout`` seconds passed; anything left is marked
        ``status="rejected"`` and counted in
        ``serve_rejected_total{reason="shutdown"}``.  Returns True iff every
        pending request completed.  Idempotent; `submit` raises after."""
        if self._closed:
            return self.batcher.pending() == 0
        self._closed = True
        t_end = (None if timeout is None
                 else time.perf_counter() + float(timeout))
        if drain:
            while self.batcher.pending():
                if t_end is not None and time.perf_counter() >= t_end:
                    break
                self.step(force=True)
        leftovers = self.batcher.drain()
        if leftovers:
            now = time.perf_counter()
            c = self.registry.counter(
                "serve_rejected_total", labels={"reason": "shutdown"},
                desc="requests rejected at engine shutdown")
            for r in leftovers:
                r.status = "rejected"
                r.t_done = now
                c.inc()
        return not leftovers

    def run_trace(self, seeds: Sequence[int]) -> list[Request]:
        """Replay a request trace through the micro-batcher (wall clock)."""
        reqs = []
        for s in seeds:
            reqs.append(self.submit(int(s)))
            self.step()
        self.step(force=True)
        return reqs

    def summary(self) -> dict:
        """Metric summary read from the bounded registry histograms."""
        st = self.stats
        n_req = st.latency.count
        wall = ((st.t_last_done - st.t_first_submit)
                if n_req and st.t_last_done is not None else 0.0)
        return {
            "requests": n_req,
            "batches": st.batch_size.count,
            "req_per_s": n_req / wall if wall > 0 else float("nan"),
            "p50_ms": st.latency.percentile(50) * 1e3,
            "p99_ms": st.latency.percentile(99) * 1e3,
            "queue_wait_p50_ms": st.queue_wait.percentile(50) * 1e3,
            "batch_occupancy": (st.batch_size.mean / self.serving.max_batch
                                if st.batch_size.count else 0.0),
            "avg_sub_nodes": (st.sub_nodes.mean if st.sub_nodes.count
                              else 0.0),
            "cache": self.cache.stats(),
        }
