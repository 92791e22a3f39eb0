"""Plan cache: amortize advisor runs across serving requests.

Port of `src/repro/serving/plan_cache.py` (`PlanCache`, `bucket_pow2`,
`shape_class_fingerprint`, `graph_key`), with the reference's two modes
for the sampled loader: ``with_backward`` (train-ready plans) and
``config_fn`` (a caller's heuristic in place of the tuner).  Two levels,
from cheapest to most general:

  * **exact level** — blake2b over the (bucketed) subgraph's CSR bytes +
    edge values + arch key -> a ready `CacheEntry` (plan, device-resident
    schedule and executor).  Hot seeds and repeated batches skip ALL
    preprocessing.
  * **config level** — `shape_class_fingerprint` -> `AggConfig`, so the
    §7 tuner runs once per workload *shape class*; a fingerprint hit still
    rebuilds the (cheap, vectorized) partition via `plan_for` but skips
    the evolutionary search.

Shape bucketing: subgraph node counts are padded to powers of two before
partitioning and tile counts are padded to powers of two here, so the
kernels see a small recurring set of operand shapes.  Padded tiles carry
all-zero edge values, so they contribute nothing to any output row.

Mutable graphs: a caller stamps its graph epoch on every lookup
(`get_or_build(epoch=)`); the epoch is part of the exact key, and
`invalidate(fingerprint=, before_epoch=)` drops what a mutation made
stale.  Left for a later slice: measured variant selection.  The port adds a ``variant`` knob that stamps the
gather kernel onto every plan (the reference reaches other variants only
through measurement).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from repro_torch.core.advisor import plan_for
from repro_torch.core.aggregate import PlanExecutor
from repro_torch.core.model import AggConfig
from repro_torch.core.partition import pad_partition_tiles
from repro_torch.core.plan import Plan
from repro_torch.graphs.csr import CSRGraph
from repro_torch.obs import MetricsRegistry

__all__ = ["CacheEntry", "PlanCache", "bucket_pow2", "graph_key",
           "shape_class_fingerprint"]


def bucket_pow2(x: int, lo: int = 1) -> int:
    """Smallest power of two >= max(x, lo)."""
    x = max(int(x), lo)
    return 1 << (x - 1).bit_length()


def shape_class_fingerprint(g: CSRGraph, arch_key: tuple = ()) -> tuple:
    """Coarse workload signature: graphs that share it get the same tuned
    config.  Pow2 size buckets + a 16-bin log2-degree histogram quantized
    to 1/4ths of the working node count (isolated nodes excluded).
    Content-BLIND, which is safe because every planned graph is ephemeral
    and exact-keyed anyway (the serving engine's ego-graph batches, the
    sampled loader's freshly drawn blocks, both with the graph epoch in the
    exact key): the memo only ever transfers a tuned CONFIG, never a plan.
    The reference's content-aware default, `graph_fingerprint`, serves
    long-lived mutable graphs planned through the cache; the port plans
    none (a resident plan takes its deltas through `Plan.apply_delta`)."""
    degs = g.degrees
    degs = degs[degs > 0]
    hist = (np.bincount(np.minimum(np.log2(degs).astype(np.int64), 15),
                        minlength=16)
            if len(degs) else np.zeros(16, np.int64))
    frac = tuple(int(x) for x in
                 np.round(4.0 * hist / max(len(degs), 1)).astype(np.int64))
    return (bucket_pow2(g.num_nodes), bucket_pow2(max(g.num_edges, 1)),
            frac, tuple(arch_key))


def graph_key(g: CSRGraph, edge_vals: Optional[np.ndarray],
              arch_key: tuple = ()) -> tuple:
    """Exact identity of a (subgraph, edge values, arch) triple."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(g.indptr).tobytes())
    h.update(np.ascontiguousarray(g.indices).tobytes())
    if edge_vals is not None:
        h.update(np.ascontiguousarray(edge_vals, dtype=np.float32).tobytes())
    return (h.hexdigest(), tuple(arch_key))


@dataclasses.dataclass
class CacheEntry:
    plan: Plan
    executor: PlanExecutor
    apply_fn: Optional[Callable] = None   # engine-installed forward
    hits: int = 0
    # keyed-invalidation handles: the fingerprint the entry was built under
    # and the graph epoch the caller stamped (`get_or_build(epoch=...)`);
    # `invalidate()` selects on these
    fingerprint: Optional[tuple] = None
    epoch: int = 0


class PlanCache:
    """LRU plan cache + fingerprint->config memo (see module docstring).

    ``max_plans`` LRU-bounds the ready-plan level (None = unbounded) and
    ``max_configs`` the config memo; evictions show in `stats()`.
    ``backend`` / ``device`` are where every built executor runs;
    ``variant`` is stamped onto every plan's config.  ``registry``:
    optional shared `MetricsRegistry` (hit/miss/eviction counters, build
    time, tuner cost, per-source build provenance).

    ``with_backward``: every built plan also carries the transposed
    graph's schedule (`plan_for(with_backward=True)`), so entries are
    train-ready; the arch key gains ``("bwd",)``, so a forward-only
    serving entry is never handed to a trainer, and with
    ``bucket_shapes`` the backward tile count is pow2-padded beside the
    forward's.  ``config_fn``: optional ``(CSRGraph) -> AggConfig``
    consulted on a fingerprint miss in place of the tuner (its
    ``feat_dtype`` forced to the cache's); the build counts under
    ``plan_cache_builds_total{source="heuristic"}``.
    """

    def __init__(self, *, backend: str = "cuda", device="cuda",
                 tune_mode: str = "model", tune_iters: int = 8,
                 max_plans: Optional[int] = 64,
                 max_configs: Optional[int] = None,
                 bucket_shapes: bool = True, seed: int = 0,
                 feat_dtype: str = "float32", variant: str = "folded",
                 with_backward: bool = False,
                 config_fn: Optional[Callable[[CSRGraph], AggConfig]] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.backend = backend
        self.device = device
        self.tune_mode = tune_mode
        self.tune_iters = tune_iters
        self.feat_dtype = feat_dtype
        self.variant = variant
        self.max_plans = max_plans
        self.max_configs = max_configs
        self.bucket_shapes = bucket_shapes
        self.seed = seed
        self.with_backward = with_backward
        self.config_fn = config_fn
        self._lock = threading.RLock()
        self._plans: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._configs: "OrderedDict[tuple, AggConfig]" = OrderedDict()
        self.exact_hits = 0
        self.config_hits = 0
        self.misses = 0
        self.evictions = 0
        self.config_evictions = 0
        self.invalidations = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        self._c_exact = self.registry.counter(
            "plan_cache_exact_hits_total", desc="ready-plan cache hits")
        self._c_config = self.registry.counter(
            "plan_cache_config_hits_total",
            desc="fingerprint->config memo hits (plan rebuilt, tuner skipped)")
        self._c_miss = self.registry.counter(
            "plan_cache_misses_total", desc="full cache misses")
        self._c_evict = self.registry.counter(
            "plan_cache_evictions_total", desc="plan-level LRU evictions")
        self._c_cfg_evict = self.registry.counter(
            "plan_cache_config_evictions_total",
            desc="config-memo LRU evictions")
        self._c_invalidate = self.registry.counter(
            "plan_cache_invalidations_total",
            desc="entries dropped by keyed invalidation (graph mutations)")
        self._h_build = self.registry.histogram(
            "plan_cache_build_seconds",
            desc="plan_for + tile padding + executor build on the miss path")
        self._c_tuner_runs = self.registry.counter(
            "tuner_runs_total", desc="evolutionary searches run")
        self._c_tuner_evals = self.registry.counter(
            "tuner_evaluations_total",
            desc="unique tuner score-fn evaluations (TunerResult.evaluations)")

    def get_or_build(self, g: CSRGraph, *, arch: str, in_dim: int,
                     hidden_dim: int, num_layers: int,
                     edge_vals: Optional[np.ndarray] = None,
                     epoch: Optional[int] = None) -> CacheEntry:
        with self._lock:
            return self._get_or_build_locked(
                g, arch=arch, in_dim=in_dim, hidden_dim=hidden_dim,
                num_layers=num_layers, edge_vals=edge_vals, epoch=epoch)

    def _get_or_build_locked(self, g: CSRGraph, *, arch: str, in_dim: int,
                             hidden_dim: int, num_layers: int,
                             edge_vals: Optional[np.ndarray] = None,
                             epoch: Optional[int] = None
                             ) -> CacheEntry:
        arch_key = (arch, in_dim, hidden_dim, num_layers, self.feat_dtype,
                    self.variant) + (("bwd",) if self.with_backward else ())
        # the graph epoch is part of the EXACT key only: a plan may never
        # be served across a mutation boundary, but the shape-class config
        # memo transfers
        exact_key = arch_key if epoch is None else arch_key + ("epoch",
                                                               epoch)
        key = graph_key(g, edge_vals, exact_key)
        ent = self._plans.get(key)
        if ent is not None:
            self._plans.move_to_end(key)
            self.exact_hits += 1
            self._c_exact.inc()
            ent.hits += 1
            return ent

        fp = shape_class_fingerprint(g, arch_key)
        config = self._configs.get(fp)
        if config is not None:
            self._configs.move_to_end(fp)
            self.config_hits += 1
            self._c_config.inc()
            source = "memo"
        else:
            self.misses += 1
            self._c_miss.inc()
            source = "heuristic" if self.config_fn is not None else "tuner"
            if self.config_fn is not None:
                config = self.config_fn(g)
                if config.feat_dtype != self.feat_dtype:
                    config = dataclasses.replace(
                        config, feat_dtype=self.feat_dtype)
                self._set_config(fp, config)
        t_build = time.perf_counter()
        plan = plan_for(g, arch=arch, in_dim=in_dim, hidden_dim=hidden_dim,
                        num_layers=num_layers, edge_vals=edge_vals,
                        config=config, tune_mode=self.tune_mode,
                        tune_iters=self.tune_iters, seed=self.seed,
                        with_backward=self.with_backward,
                        feat_dtype=self.feat_dtype, variant=self.variant)
        if config is None:
            self._set_config(fp, plan.config)
        if plan.tuner is not None:
            self._c_tuner_runs.inc()
            self._c_tuner_evals.inc(plan.tuner.evaluations)
        if self.bucket_shapes:
            part = pad_partition_tiles(
                plan.partition, bucket_pow2(plan.partition.num_tiles))
            part_bwd = plan.partition_bwd
            if part_bwd is not None:
                part_bwd = pad_partition_tiles(
                    part_bwd, bucket_pow2(part_bwd.num_tiles))
            plan = dataclasses.replace(plan, partition=part,
                                       partition_bwd=part_bwd)
        ent = CacheEntry(plan=plan,
                         executor=plan.executor(self.backend, self.device),
                         fingerprint=fp, epoch=0 if epoch is None else epoch)
        self._h_build.observe(time.perf_counter() - t_build)
        self.registry.counter(
            "plan_cache_builds_total", labels={"source": source},
            desc="plans built, by AggConfig provenance").inc()
        self._plans[key] = ent
        while self.max_plans is not None and len(self._plans) > self.max_plans:
            self._plans.popitem(last=False)
            self.evictions += 1
            self._c_evict.inc()
        return ent

    def _set_config(self, fp: tuple, config: AggConfig) -> None:
        with self._lock:
            self._configs[fp] = config
            self._configs.move_to_end(fp)
            while (self.max_configs is not None
                   and len(self._configs) > self.max_configs):
                self._configs.popitem(last=False)
                self.config_evictions += 1
                self._c_cfg_evict.inc()

    def invalidate(self, fingerprint: Optional[tuple] = None, *,
                   before_epoch: Optional[int] = None) -> int:
        """Keyed invalidation after a graph mutation.

        ``fingerprint``: drop the ready plans built under that fingerprint
        plus its config-memo entry.  ``before_epoch``: drop every ready
        plan stamped with an earlier graph epoch (the serving engine's
        swap protocol: entries for egos of the pre-mutation snapshot); the
        config memo is kept, a shape-class tuning decision survives
        content changes.  With neither selector both levels are dropped.
        Returns the number of entries removed; each removal counts into
        ``plan_cache_invalidations_total``."""
        with self._lock:
            n = 0
            for key in list(self._plans):
                ent = self._plans[key]
                if fingerprint is not None and ent.fingerprint != fingerprint:
                    continue
                if before_epoch is not None and ent.epoch >= before_epoch:
                    continue
                del self._plans[key]
                n += 1
            if fingerprint is not None:
                if self._configs.pop(fingerprint, None) is not None:
                    n += 1
            elif before_epoch is None:
                n += len(self._configs)
                self._configs.clear()
            self.invalidations += n
            self._c_invalidate.inc(n)
            return n

    @property
    def num_plans(self) -> int:
        with self._lock:
            return len(self._plans)

    @property
    def num_configs(self) -> int:
        with self._lock:
            return len(self._configs)

    def stats(self) -> dict:
        with self._lock:
            total = self.exact_hits + self.config_hits + self.misses
            hits = self.exact_hits + self.config_hits
            return {
                "lookups": total,
                "exact_hits": self.exact_hits,
                "config_hits": self.config_hits,
                "misses": self.misses,
                "hit_rate": hits / total if total else 0.0,
                "plans": len(self._plans),
                "configs": len(self._configs),
                "evictions": self.evictions,
                "config_evictions": self.config_evictions,
                "invalidations": self.invalidations,
            }
