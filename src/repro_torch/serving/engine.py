"""Serving engines: node-level GNN prediction against resident graphs.

Port of `ServingEngine`, `TenantSpec` and `AsyncServingEngine` from
`src/repro/serving/engine.py`.  Two tiers share one request substrate:

* `ServingEngine` — the synchronous, thread-free micro-batching engine
  (callers drive the clock explicitly):

      submit(seed) -> MicroBatcher -> k-hop ego-graph union (or disjoint
      union) -> shape bucketing -> PlanCache (advisor config + partition +
      device schedule reuse) -> batched aggregation kernels -> per-seed
      logits.

* `AsyncServingEngine` — the production tier on top: a bounded admission
  queue per tenant, a deadline-aware continuous batcher
  (`serving.batcher.DeadlineBatcher`, compute estimates read from this
  process's `MetricsRegistry` histograms), an EDF scheduler across
  tenants, and a single executor worker thread that fires batches against
  any ``serve_fn(seeds) -> logits`` — a `ServingEngine.serve_batch`
  bound method on the single-device path.  The async engine names no
  device: the tenant's engine does (``cfg.device``), and its work runs
  from the worker thread.

PyTorch runs eagerly, so the reference's jit cache has no counterpart:
a cache entry's forward is the model's plain `logits`.  Features ship
host -> device per batch at the policy dtype, and the ``compute`` span
synchronizes the device so it times the device work.

GCN edge values are computed ONCE from the resident graph's degrees and
sliced into every subgraph, so batched ego inference is numerically
identical to full-graph inference at the seeds.  Both engines take graph
deltas (`update_graph`).  `make_sharded_serve_fn` answers requests from
the sharded full-graph forward over a rank group
(`repro_torch.distributed.graph_shard`), and takes deltas too.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device, set_matmul_precision
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.delta import extend_node_features
from repro_torch.graphs.subgraph import batch_egos, extract_ego, pad_to_nodes
from repro_torch.models.gnn import (GNNConfig, GNNModel, gcn_edge_values,
                                    init_gnn_params)
from repro_torch.obs import MetricsRegistry, SpanTracer, pow2_bounds
from repro_torch.serving.admission import AdmissionQueue, AsyncRequest, SLOClass
from repro_torch.serving.batcher import (ClockBatcher, DeadlineBatcher,
                                         MicroBatcher, Request)
from repro_torch.serving.plan_cache import PlanCache, bucket_pow2

__all__ = ["AsyncServingEngine", "ServingConfig", "ServingEngine",
           "TenantSpec", "make_sharded_serve_fn"]


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
        # delta generation of the resident graph; folded into the plan
        # cache's exact key so pre-mutation plans can never serve a
        # post-mutation graph
        self.graph_epoch = 0
        self._g_epoch = self.registry.gauge(
            "plan_epoch", desc="delta generation of the resident graph "
                               "the engine's plans are built against")
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
                    edge_vals=vals, epoch=self.graph_epoch)
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

    # ---------------- graph mutation ----------------

    def update_graph(self, delta):
        """Swap the resident graph to ``delta`` applied to the current
        snapshot; returns the `repro_torch.graphs.delta.DeltaResult`.

        The engine is thread-free, so the swap is a plain reference
        replacement: the next `serve_batch` extracts egos from the new
        snapshot.  (Under `AsyncServingEngine` this runs on the single
        worker thread between fired batches — the async tier's safe epoch
        boundary; in-flight batches complete against the old snapshot.)
        GCN's A-hat weights are recomputed from the new degrees; features
        for new nodes come from ``delta.node_feat`` (zeros if absent).
        ``graph_epoch`` is
        bumped (part of every plan-cache exact key, so pre-mutation plans
        cannot be hit) and pre-mutation entries are dropped via
        ``PlanCache.invalidate(before_epoch=...)`` — on a SHARED cache
        this also drops other engines' older-epoch entries, which is a
        rebuild cost, never a correctness issue.
        """
        res = self.graph.apply_delta(delta)
        g2 = res.graph
        feat2 = extend_node_features(self.feat, delta, g2.num_nodes)
        if self.cfg.arch == "gcn":
            src_graph, src_vals = gcn_edge_values(g2)
        else:
            src_graph, src_vals = g2, None
        self.graph, self.feat = g2, feat2
        self.src_graph, self.src_vals = src_graph, src_vals
        self.graph_epoch += 1
        self._g_epoch.set(self.graph_epoch)
        self.cache.invalidate(before_epoch=self.graph_epoch)
        return res

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


# ====================================================================
#                         async serving tier
# ====================================================================

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of the async engine: a model/graph executor plus its
    admission policy.

    ``serve_fn(seeds) -> (len(seeds), C)`` is the tenant's executor — a
    bound `ServingEngine.serve_batch` (single device, per-tenant ego
    extraction + shared `PlanCache`) or any callable with that contract
    (tests use stubs).

    ``update_fn(delta)`` optionally names the tenant's graph-mutation
    handler for `AsyncServingEngine.update_graph`; when absent the engine
    resolves one from ``serve_fn`` itself (an ``update_graph`` attribute,
    or the bound `ServingEngine` behind a ``serve_batch`` method).
    """

    name: str
    serve_fn: Callable[[Sequence[int]], np.ndarray]
    slo: SLOClass = SLOClass("silver", 0.5)
    max_batch: int = 32            # batch size cap (pow2 bucket cap)
    queue_cap: int = 4096          # admission bound; beyond it -> reject
    update_fn: Optional[Callable] = None


class _TenantState:
    """Engine-internal per-tenant state: admission queue, batcher, and the
    registry instruments (all labelled ``{tenant=...}``)."""

    def __init__(self, spec: TenantSpec, batcher, registry: MetricsRegistry):
        self.spec = spec
        self.batcher = batcher
        self.queue = AdmissionQueue(spec.name, capacity=spec.queue_cap,
                                    slo=spec.slo)
        lab = {"tenant": spec.name}
        self.g_depth = registry.gauge(
            "serve_queue_depth", labels=lab,
            desc="requests admitted but not yet fired")
        self.c_submitted = registry.counter(
            "serve_submitted_total", labels=lab,
            desc="submit() calls (admitted + rejected)")
        self.c_completed = registry.counter(
            "serve_completed_total", labels=lab,
            desc="requests completed with a result")
        self.c_slo_met = registry.counter(
            "serve_slo_met_total", labels=lab,
            desc="completions within the tenant's SLO budget")
        self.c_slo_missed = registry.counter(
            "serve_slo_missed_total", labels=lab,
            desc="completions past the tenant's SLO budget")
        self.h_latency = registry.histogram(
            "serve_request_latency_seconds", labels=lab,
            desc="submit -> completion latency")
        self.h_queue_wait = registry.histogram(
            "serve_queue_wait_seconds", labels=lab,
            desc="submit -> batch-fire queue wait")
        self.h_compute = registry.histogram(
            "serve_batch_compute_seconds", labels=lab,
            desc="serve_fn wall time per fired batch (feeds the deadline "
                 "batcher's compute estimate)")
        self.h_batch = registry.histogram(
            "serve_batch_size", labels=lab, unit="",
            bounds=pow2_bounds(4096), desc="requests per fired batch")
        self._c_rejected = {}
        self._registry = registry
        self._lab = lab

    def c_rejected(self, reason: str):
        c = self._c_rejected.get(reason)
        if c is None:
            c = self._registry.counter(
                "serve_rejected_total", labels={**self._lab, "reason": reason},
                desc="requests rejected, by reason")
            self._c_rejected[reason] = c
        return c


class AsyncServingEngine:
    """Async, SLO-aware, multi-tenant serving front door.

    Request path::

        submit(seed, tenant) -> AdmissionQueue (bounded; rejects on
        overflow/shutdown) -> per-tenant DeadlineBatcher (planned close =
        tightest deadline - measured compute estimate - margin) -> EDF
        pick across tenants -> worker thread -> tenant serve_fn ->
        AsyncRequest.complete

    One worker thread executes batches serially (modelling one device's
    serving lane); admission, batching state and scheduling all live
    under a single condition variable, so the cross-tenant pick is always
    made against a consistent snapshot.  Per-tenant isolation comes from
    earliest-deadline-first: a tenant flooding its (bounded) queue can
    delay another tenant by at most one in-flight batch, because the
    moment the other tenant's batch is due its earlier deadline wins the
    pick.

    ``policy="deadline"`` (default) uses `DeadlineBatcher` with a compute
    estimate read live from each tenant's
    ``serve_batch_compute_seconds`` histogram (p90); ``policy="clock"``
    is the fixed-window baseline (`ClockBatcher`) it is compared against.

    Shutdown contract (`close`): every admitted request is either
    completed or reported rejected — never dropped.  With
    ``drain=True`` the worker force-closes and executes remaining
    batches (EDF order) before exiting; a ``timeout`` bounds the wait,
    after which still-queued requests are rejected with reason
    ``"shutdown"``.  With ``drain=False`` queued requests are rejected
    immediately (the in-flight batch, if any, still completes).
    """

    def __init__(self, tenants: Sequence[TenantSpec], *,
                 policy: str = "deadline", window: float = 0.02,
                 margin: float = 0.002, idle_gap: Optional[float] = 0.008,
                 registry: Optional[MetricsRegistry] = None,
                 start: bool = True):
        if not tenants:
            raise ValueError("need at least one TenantSpec")
        if policy not in ("deadline", "clock"):
            raise ValueError(f"unknown policy {policy!r}")
        self.policy = policy
        self.registry = registry if registry is not None else MetricsRegistry()
        self._cond = threading.Condition()
        self._tenants: "OrderedDict[str, _TenantState]" = OrderedDict()
        for spec in tenants:
            if spec.name in self._tenants:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self._tenants[spec.name] = ts = _TenantState(
                spec, None, self.registry)
            if policy == "deadline":
                # est_fn reads the tenant's measured compute histogram at
                # decision time — the batcher plans with live data
                ts.batcher = DeadlineBatcher(
                    max_batch=spec.max_batch, margin=margin,
                    idle_gap=idle_gap,
                    est_fn=(lambda h=ts.h_compute:
                            h.percentile(90) if h.count else 0.0))
            else:
                ts.batcher = ClockBatcher(max_batch=spec.max_batch,
                                          window=window)
        self._default = next(iter(self._tenants))
        self._next_rid = 0
        self._outstanding = 0          # admitted, not yet terminal
        # graph mutations queued by update_graph(); the worker applies
        # them BETWEEN fired batches (the safe epoch boundary — an
        # in-flight batch always completes against the snapshot it
        # started on, and no request is dropped by a swap)
        self._pending_updates: list = []
        self._c_updates = self.registry.counter(
            "serve_graph_updates_total",
            desc="graph deltas applied at batch boundaries")
        self._c_update_errors = self.registry.counter(
            "serve_graph_update_errors_total",
            desc="tenant graph-update handlers that raised")
        self._closing = False
        self._abort = False
        self._worker_done = False
        self._thread = threading.Thread(
            target=self._worker, name="serve-worker", daemon=True)
        if start:
            self._thread.start()

    # ---------------- submission ----------------

    def submit(self, seed: int, tenant: Optional[str] = None,
               now: Optional[float] = None) -> AsyncRequest:
        """Admit one request; returns immediately.  The request is
        rejected (terminal, with a reason) rather than raising when the
        tenant queue is full or the engine is shutting down."""
        name = self._default if tenant is None else tenant
        ts = self._tenants[name]            # KeyError = caller bug
        now = time.perf_counter() if now is None else now
        with self._cond:
            req = AsyncRequest(rid=self._next_rid, tenant=name,
                               seed=int(seed), t_submit=now,
                               deadline=now + ts.spec.slo.slo_s)
            self._next_rid += 1
            ts.c_submitted.inc()
            reason = ts.queue.admit(req, ts.batcher.pending(),
                                    self._closing, now)
            if reason is not None:
                ts.c_rejected(reason).inc()
                return req
            ts.batcher.put(req, now)
            self._outstanding += 1
            ts.g_depth.set(ts.batcher.pending())
            self._cond.notify_all()
        return req

    # ---------------- worker ----------------

    def _pick_due_locked(self, now: float):
        """EDF among tenants whose batch is due; else the earliest planned
        close time to sleep toward."""
        best, best_dl, wake = None, math.inf, None
        for ts in self._tenants.values():
            if not ts.batcher.pending():
                continue
            if ts.batcher.due(now):
                dl = ts.batcher.oldest_deadline()
                if dl < best_dl:
                    best, best_dl = ts, dl
            else:
                ca = ts.batcher.close_at(now)
                wake = ca if wake is None else min(wake, ca)
        return best, wake

    def _pick_any_locked(self):
        """Drain path: the pending tenant with the earliest deadline,
        ignoring close times."""
        best, best_dl = None, math.inf
        for ts in self._tenants.values():
            if ts.batcher.pending():
                dl = ts.batcher.oldest_deadline()
                if dl < best_dl:
                    best, best_dl = ts, dl
        return best

    def _reject_queued_locked(self, reason: str, now: float) -> int:
        """Reject everything still queued (abort/shutdown-timeout path)."""
        n = 0
        for ts in self._tenants.values():
            while ts.batcher.pending():
                for r in ts.batcher.pop(now):
                    r.reject(reason, now)
                    ts.queue.on_rejected()
                    ts.c_rejected(reason).inc()
                    n += 1
            ts.g_depth.set(0)
        self._outstanding -= n
        if n:
            self._cond.notify_all()
        return n

    def _worker(self):
        try:
            while True:
                self._apply_updates()         # between batches: no batch
                #                               in flight, swap is safe
                with self._cond:
                    ts, batch = None, None
                    while batch is None:
                        now = time.perf_counter()
                        if self._abort:
                            self._reject_queued_locked("shutdown", now)
                            return
                        if self._pending_updates:
                            break             # apply, then re-pick
                        if self._closing:
                            ts = self._pick_any_locked()
                            if ts is None:
                                return
                            batch = ts.batcher.pop(now)
                            break
                        ts, wake = self._pick_due_locked(now)
                        if ts is not None:
                            batch = ts.batcher.pop(now)
                            break
                        self._cond.wait(
                            timeout=None if wake is None
                            else max(wake - now, 1e-4))
                    if batch is None:
                        continue
                    ts.g_depth.set(ts.batcher.pending())
                self._run_batch(ts, batch)
        finally:
            with self._cond:
                for _, _, ev in self._pending_updates:
                    ev.set()                  # never strand a waiter
                self._pending_updates.clear()
                self._worker_done = True
                self._cond.notify_all()

    def _apply_updates(self) -> None:
        """Drain and run queued graph updates (worker thread, no batch in
        flight).  Handlers run OUTSIDE the condition variable — replanning
        can be long, and admission must not block behind it."""
        with self._cond:
            if not self._pending_updates:
                return
            updates, self._pending_updates = self._pending_updates, []
        for handlers, delta, ev in updates:
            try:
                for fn in handlers:
                    try:
                        fn(delta)
                    except Exception:                  # noqa: BLE001
                        # a failed swap leaves that tenant on its old
                        # snapshot; serving continues, the error is counted
                        self._c_update_errors.inc()
                self._c_updates.inc()
            finally:
                ev.set()
        with self._cond:
            self._cond.notify_all()

    def _run_batch(self, ts: _TenantState, batch: list) -> None:
        t0 = time.perf_counter()
        for r in batch:
            ts.h_queue_wait.observe(max(t0 - r.t_submit, 0.0))
        try:
            out = np.asarray(ts.spec.serve_fn([r.seed for r in batch]))
        except Exception:                                  # noqa: BLE001
            # executor failure is a terminal REJECTION for the whole
            # batch, not a dropped batch — accounting stays exact
            now = time.perf_counter()
            with self._cond:
                for r in batch:
                    r.reject("error", now)
                    ts.queue.on_rejected()
                    ts.c_rejected("error").inc()
                self._outstanding -= len(batch)
                self._cond.notify_all()
            return
        t1 = time.perf_counter()
        ts.h_compute.observe(t1 - t0)
        ts.h_batch.observe(len(batch))
        slo_s = ts.spec.slo.slo_s
        with self._cond:
            for i, r in enumerate(batch):
                r.complete(out[i], t1)
                ts.queue.on_completed()
                ts.c_completed.inc()
                lat = t1 - r.t_submit
                ts.h_latency.observe(lat)
                (ts.c_slo_met if lat <= slo_s else ts.c_slo_missed).inc()
            self._outstanding -= len(batch)
            self._cond.notify_all()

    # ---------------- graph mutation ----------------

    def update_graph(self, delta, tenant: Optional[str] = None
                     ) -> threading.Event:
        """Queue a graph mutation; returns an event set once applied.

        The worker thread applies the delta BETWEEN fired batches, so the
        swap is atomic with respect to serving: every in-flight batch
        completes against the snapshot it started on, no admitted request
        is dropped, and the first batch fired after the event is set sees
        the mutated graph.  ``tenant=None`` updates every tenant that has
        a handler (deduplicated — tenants sharing one `ServingEngine`
        swap once); naming a tenant without a
        handler raises.  Handler resolution per tenant:
        ``spec.update_fn`` -> ``serve_fn.update_graph`` attribute -> the
        `ServingEngine` behind a bound ``serve_batch``.
        """
        names = [tenant] if tenant is not None else list(self._tenants)
        handlers, seen = [], set()
        for nm in names:
            spec = self._tenants[nm].spec       # KeyError = caller bug
            fn = spec.update_fn
            if fn is None:
                fn = getattr(spec.serve_fn, "update_graph", None)
            if fn is None:
                owner = getattr(spec.serve_fn, "__self__", None)
                if isinstance(owner, ServingEngine):
                    fn = owner.update_graph
            if fn is None:
                if tenant is not None:
                    raise ValueError(
                        f"tenant {tenant!r} has no graph-update handler")
                continue
            key = id(getattr(fn, "__self__", fn))
            if key not in seen:
                seen.add(key)
                handlers.append(fn)
        if not handlers:
            raise ValueError("no tenant has a graph-update handler")
        ev = threading.Event()
        with self._cond:
            if self._closing:
                raise RuntimeError("engine is shutting down")
            self._pending_updates.append((handlers, delta, ev))
            self._cond.notify_all()
        if self._thread.ident is None:          # start=False: run inline
            self._apply_updates()
        return ev

    # ---------------- lifecycle ----------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request is terminal (the batchers'
        own close policies keep firing — this does NOT force-close).
        Returns False on timeout."""
        t_end = (None if timeout is None
                 else time.perf_counter() + float(timeout))
        with self._cond:
            while self._outstanding > 0:
                if self._worker_done:
                    return self._outstanding == 0
                rem = (None if t_end is None
                       else t_end - time.perf_counter())
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(timeout=rem if rem is not None else 0.5)
        return True

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> bool:
        """Shut down; see the class docstring for the contract.  Returns
        True iff every admitted request completed or was rejected before
        return (False = timed out with the worker still busy; queued
        requests were rejected, the in-flight batch finishes on the
        daemon worker)."""
        with self._cond:
            self._closing = True
            if not drain:
                self._abort = True
            self._cond.notify_all()
        if self._thread.ident is None:        # start=False, never ran
            with self._cond:
                self._reject_queued_locked("shutdown", time.perf_counter())
            return True
        self._thread.join(timeout)
        if self._thread.is_alive():
            with self._cond:
                self._abort = True
                self._reject_queued_locked("shutdown", time.perf_counter())
                self._cond.notify_all()
            self._thread.join(0.5)
            return False
        return True

    # ---------------- introspection ----------------

    @property
    def tenants(self) -> tuple:
        return tuple(self._tenants)

    def accounting(self, tenant: Optional[str] = None) -> dict:
        """Exact request accounting — the invariant the concurrency tests
        assert: ``submitted == completed + rejected + outstanding``."""
        names = [tenant] if tenant is not None else list(self._tenants)
        sub = comp = rej = 0
        with self._cond:
            for n in names:
                q = self._tenants[n].queue
                sub += q.submitted
                comp += q.completed
                rej += q.rejected
            return {"submitted": sub, "completed": comp, "rejected": rej,
                    "outstanding": sub - comp - rej}

    def summary(self) -> dict:
        """Per-tenant serving summary (latency percentiles from the
        bounded registry histograms, SLO attainment from the met/missed
        counters)."""
        out = {}
        for name, ts in self._tenants.items():
            met = ts.c_slo_met.value
            missed = ts.c_slo_missed.value
            done = met + missed
            out[name] = {
                "slo_class": ts.spec.slo.name,
                "slo_ms": ts.spec.slo.slo_s * 1e3,
                **self.accounting(name),
                "p50_ms": ts.h_latency.percentile(50) * 1e3,
                "p99_ms": ts.h_latency.percentile(99) * 1e3,
                "slo_attainment": met / done if done else float("nan"),
                "mean_batch": (ts.h_batch.mean if ts.h_batch.count
                               else 0.0),
                "batches": ts.h_batch.count,
            }
        return out


def make_sharded_serve_fn(graph: CSRGraph, feat: np.ndarray, cfg: GNNConfig,
                          *, num_shards: int, params=None,
                          generator: Optional[torch.Generator] = None,
                          tune_iters: int = 4, variant: Optional[str] = None,
                          dist_backend: Optional[str] = None, group=None,
                          registry: Optional[MetricsRegistry] = None):
    """A ``serve_fn(seeds) -> (len(seeds), C)`` numpy array answering
    requests from the sharded full-graph forward
    (`distributed.graph_shard.make_sharded_logits_fn`): where the
    micro-batcher and the rank group meet.  Port of the reference's
    `make_sharded_serve_fn` (:917).

    The resident graph is planned ONCE (`plan_for` + `Plan.shards`, each
    sub-plan sent to its rank once) and every fired batch runs one
    sharded full-graph forward, slicing out the requested seed rows:
    numerically single-device full-graph inference.  Parameters default
    to `init_gnn_params(cfg, generator)`, the `ServingEngine`'s;
    ``variant`` pins the gather kernel (None keeps the tuner's).

    ``serve_fn.update_graph(delta)`` mutates the resident graph through
    the incremental path (`PlanShards.apply_delta` ->
    `core.shard.update_shards`): only sub-plans intersecting the dirty
    rows are recomputed, GCN A-hat weights are re-derived from the
    mutated degrees, and only sub-plans that are not the same `Plan`
    object as before are sent to their ranks again (``serve_fn.resent``,
    the ranks, one list per delta).  `AsyncServingEngine`
    resolves this attribute as the tenant's graph-update handler.
    ``serve_fn.close()`` frees the ranks' state.
    """
    import dataclasses as _dc

    from repro_torch.core.advisor import plan_for
    from repro_torch.distributed.graph_shard import make_sharded_logits_fn

    if cfg.arch == "gcn":
        src_graph, src_vals = gcn_edge_values(graph)
    elif cfg.arch == "gin":
        src_graph, src_vals = graph, None
    else:
        raise ValueError(f"sharded serving supports gcn/gin (static edge "
                         f"values), got {cfg.arch!r}")
    set_matmul_precision()
    device = resolve_device(cfg.device)
    plan = plan_for(src_graph, arch=cfg.arch, in_dim=cfg.in_dim,
                    hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                    edge_vals=src_vals, tune_iters=tune_iters,
                    feat_dtype=cfg.feat_dtype, variant=variant)
    shards = plan.shards(num_shards)
    if params is None:
        params = init_gnn_params(cfg, generator)
    logits_fn = make_sharded_logits_fn(cfg, shards, group=group,
                                       dist_backend=dist_backend,
                                       registry=registry)
    feat = np.ascontiguousarray(feat, dtype=np.float32)
    state = {"graph": graph, "shards": shards, "feat": feat,
             "feat_dev": torch.from_numpy(feat).to(device)}

    def serve_fn(seeds: Sequence[int]) -> np.ndarray:
        out = logits_fn(params, state["feat_dev"]).cpu().numpy()
        return out[np.asarray(list(seeds), dtype=np.int64)]

    def _ahat_vals(g2_plan: CSRGraph) -> np.ndarray:
        # A-hat weights from the mutated PLAN-ORDER graph itself: it
        # already carries the self-loops, so this reproduces
        # `gcn_edge_values` without the external-order edge array
        inv = 1.0 / np.sqrt(np.maximum(g2_plan.degrees.astype(np.float64),
                                       1.0))
        rows, cols = g2_plan.to_coo()
        return (inv[rows] * inv[cols]).astype(np.float32)

    def update_graph(delta):
        g_old = state["graph"]
        res = g_old.apply_delta(delta)        # raw snapshot: id space/feat
        g2 = res.graph
        if cfg.arch == "gcn":
            # the plan graph carries self-loops: mirror the delta there,
            # inserting loops for new nodes and re-inserting them for
            # del_nodes (node deletion empties the row, the id survives)
            loops = np.concatenate([
                np.arange(g_old.num_nodes, g2.num_nodes, dtype=np.int64),
                np.asarray([] if delta.del_nodes is None else delta.del_nodes,
                           np.int64).ravel()])
            add_src = np.asarray([] if delta.add_src is None
                                 else delta.add_src, np.int64).ravel()
            add_dst = np.asarray([] if delta.add_dst is None
                                 else delta.add_dst, np.int64).ravel()
            delta_plan = _dc.replace(
                delta, add_src=np.concatenate([add_src, loops]),
                add_dst=np.concatenate([add_dst, loops]), add_val=None)
            shards2 = state["shards"].apply_delta(delta_plan,
                                                  edge_vals=_ahat_vals)
        else:
            shards2 = state["shards"].apply_delta(delta)
        feat2 = extend_node_features(state["feat"], delta, g2.num_nodes)
        serve_fn.resent.append(logits_fn.model.update_shards(shards2))
        state.update(graph=g2, shards=shards2, feat=feat2,
                     feat_dev=torch.from_numpy(feat2).to(device))
        serve_fn.plan = shards2.parent
        serve_fn.shards = shards2
        return res

    serve_fn.plan = plan          # introspection for tests/benchmarks
    serve_fn.shards = shards
    serve_fn.params = params
    serve_fn.resent = []
    serve_fn.model = logits_fn.model
    serve_fn.feat = lambda: state["feat_dev"]
    serve_fn.logits = lambda: logits_fn(params, state["feat_dev"])
    serve_fn.update_graph = update_graph
    serve_fn.close = logits_fn.model.close
    return serve_fn
