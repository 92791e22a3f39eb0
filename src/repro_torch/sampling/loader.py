"""Mini-batch loader + train step for neighbor-sampled GNN training.

Port of `src/repro/sampling/loader.py` (`sampled_agg_config`,
`LoaderConfig`, `TrainBatch`, `SampledLoader` with its graph swap,
`SampledTrainStep`).
`SampledLoader` turns a resident graph + features + labels into a
deterministic stream of device-ready `TrainBatch`es:

  1. seeds for step s are a slice of a per-epoch permutation (seeded by
     ``(seed, epoch)``), and the fanout sampler is seeded by ``(seed,
     step)`` — ``batch_for(step)`` is a pure function of the step index,
     which is the `runtime.Trainer` restart contract;
  2. every block is padded to pow2 *node* buckets (`pad_to_nodes` +
     `bucket_pow2`) and planned through a `PlanCache` (``with_backward``
     on the ``"cuda"`` backend), whose ``bucket_shapes`` mode pads *tile*
     counts to pow2;
  3. a background thread prefetches batches into a double buffer
     (``PREFETCH = 2``): host-side sampling + planning for step s+1 overlaps
     device compute for step s.  Out-of-order requests (a Trainer restart)
     flush the buffer and resync — determinism makes that loss-free.

The worker thread also uploads each batch to the device: the plan cache
builds the entries' `PlanExecutor`s (their `DeviceSchedule`s) and
`batch_for` copies the padded features, labels and mask.  Every copy is
a synchronous copy from pageable host memory, so a batch in the buffer is
complete on the device before the consumer sees it; a worker exception
reaches the consumer and no half-built batch is ever buffered.

Mutable graphs: `SampledLoader.update_graph` hands a new snapshot to the
worker, which installs it between batch builds.  A batch built from the
old snapshot is never handed out once ``update_graph`` has returned:
buffered batches are dropped, a batch in flight is discarded when it
finishes, and the consumer waits for the swap before it takes a batch.
Every batch carries the ``graph_epoch`` it was built from.

`ShardedSampledTrainStep` is data-parallel sampled training over a rank
group (`repro_torch.distributed.ranks`): each rank holds a loader over
the one graph the caller hands it and builds its own share of every
step's batches.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, set_matmul_precision
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.delta import extend_node_features
from repro_torch.graphs.subgraph import pad_to_nodes
from repro_torch.models.gnn import GNNConfig, gnn_block_loss
from repro_torch.obs import MetricsRegistry
from repro_torch.sampling.neighbor import sample_blocks
from repro_torch.serving.plan_cache import PlanCache, bucket_pow2

__all__ = ["LoaderConfig", "TrainBatch", "SampledLoader", "SampledTrainStep",
           "ShardedSampledTrainStep", "sampled_agg_config"]


def sampled_agg_config(g: CSRGraph):
    """Schedule knobs for fanout-sampled bipartite blocks (the reference's
    heuristic, unchanged).

    The §7 tuner's kernel model prices full graphs, where most
    (node_block, window) buckets are dense; sampled blocks are the
    opposite — a few fanout-bounded edges scattered over a wide frontier.
    Wide windows (~num_nodes/8) with small groups-per-tile keep bucket
    padding bounded.
    """
    from repro_torch.core.model import AggConfig
    src_win = min(max(bucket_pow2(max(g.num_nodes // 8, 1)), 256), 4096)
    return AggConfig(gs=8, gpt=8, dt=128, src_win=src_win, ont=8,
                     variant="folded")


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    """The loader's settings.  The reference's other knobs are fixed here
    at the values its loader runs by default: configs from
    `sampled_agg_config` (no tuner), pow2 node and tile buckets, a ragged
    last batch dropped, ``PREFETCH`` batches buffered, ``MAX_PLANS``
    plans cached."""

    fanouts: tuple                  # per-layer fanout, forward order
    batch_nodes: int                # seeds per mini-batch
    seed: int = 0
    variant: str = "folded"         # port: gather kernel stamped on plans


PREFETCH = 2                        # double buffering depth
MAX_PLANS = 32                      # plan-cache LRU bound


@dataclasses.dataclass
class TrainBatch:
    """One device-ready sampled mini-batch (tensors on the loader's
    device)."""

    feat: torch.Tensor              # (P0, in_dim) at cfg.compute_dtype
    labels: torch.Tensor            # (P_last,) int64, padded with 0
    mask: torch.Tensor              # (P_last,) float32, 1.0 on real seeds
    entries: list                   # per-layer plan-cache CacheEntry
    seeds: np.ndarray               # (B,) global seed ids
    num_seeds: int
    step: int
    key: tuple                      # shape-bucket signature (statics + shapes)
    raw_nodes: tuple                # per-block UNPADDED src counts
    raw_edges: tuple                # per-block UNPADDED edge counts
    graph_epoch: int = 0            # loader graph epoch it was built from


class SampledLoader:
    """Deterministic, prefetching mini-batch source (see module doc).

    Callable — ``loader(step)`` returns the batch for ``step`` (through the
    prefetch buffer), so it drops straight into `Trainer(batch_fn=loader)`.
    Use as a context manager or call `close()` to stop the worker thread.
    Batches live on ``cfg.device`` and their entries execute on
    ``cfg.backend``.
    """

    def __init__(self, g: CSRGraph, feat: np.ndarray, labels: np.ndarray,
                 cfg: GNNConfig, loader: LoaderConfig, *,
                 train_nodes: Optional[np.ndarray] = None,
                 with_backward: Optional[bool] = None,
                 start_thread: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        if cfg.arch not in ("gcn", "gin"):
            # fail at construction, not inside the first step (gat needs
            # per-block dynamic-edge plumbing the sampled path lacks)
            raise ValueError(
                f"sampled training supports gcn/gin, not {cfg.arch!r}")
        if len(loader.fanouts) != cfg.num_layers:
            raise ValueError(
                f"fanouts {loader.fanouts} must name one fanout per layer "
                f"(num_layers={cfg.num_layers})")
        if feat.shape != (g.num_nodes, cfg.in_dim):
            raise ValueError(f"feat is {feat.shape}, the graph and config "
                             f"need {(g.num_nodes, cfg.in_dim)}")
        set_matmul_precision()
        self.device = resolve_device(cfg.device)
        self.g = g
        self.feat = np.ascontiguousarray(feat, dtype=np.float32)
        self.labels = np.ascontiguousarray(labels, dtype=np.int32)
        self.cfg = cfg
        self.lc = loader
        self.train_nodes = (np.arange(g.num_nodes, dtype=np.int64)
                            if train_nodes is None
                            else np.asarray(train_nodes, dtype=np.int64))
        if with_backward is None:
            with_backward = cfg.backend == "cuda"
        # sample/plan time per batch, prefetch stall seen by the consumer
        # and resync events, in the registry the plan cache shares
        self.registry = registry if registry is not None else MetricsRegistry()
        self._h_sample = self.registry.histogram(
            "loader_sample_seconds",
            desc="fanout sampling + padding + planning per batch")
        self._h_stall = self.registry.histogram(
            "loader_prefetch_stall_seconds",
            desc="consumer wait for a batch (0 when the prefetch buffer hit)")
        self._c_batches = self.registry.counter(
            "loader_batches_built_total", desc="sampled batches constructed")
        self._c_resync = self.registry.counter(
            "loader_resyncs_total",
            desc="prefetch-buffer flushes on out-of-order access (restarts)")
        self._c_swaps = self.registry.counter(
            "loader_graph_swaps_total",
            desc="resident-graph replacements applied at batch boundaries")
        self._g_epoch = self.registry.gauge(
            "loader_graph_epoch", desc="delta generation of the resident graph")
        # sampled blocks are ephemeral subgraphs keyed EXACTLY in the plan
        # cache; the shape-class fingerprint keeps the config memo hot
        self.cache = PlanCache(
            backend=cfg.backend, device=self.device, max_plans=MAX_PLANS,
            bucket_shapes=True, seed=loader.seed, feat_dtype=cfg.feat_dtype,
            variant=loader.variant, with_backward=with_backward,
            config_fn=sampled_agg_config, registry=self.registry)
        self.edge_mode = "gcn" if cfg.arch == "gcn" else "scale"
        self._default_train_nodes = train_nodes is None
        self.graph_epoch = 0
        self._set_steps_per_epoch()
        # prefetch state
        self._cond = threading.Condition()
        self._buf: dict[int, TrainBatch] = {}
        self._head = 0                  # next step the worker picks up
        self._inflight: Optional[int] = None  # step the worker is computing
        self._last_req = 0              # most recently requested step
        self._resume = 0                # the step the consumer needs next
        self._pending_swap = None       # (g, feat, labels, epoch) installed
        #                                 at a batch boundary (update_graph)
        self._update_lock = threading.Lock()  # serializes update_graph
        self._stop = False
        self._err: Optional[BaseException] = None
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _set_steps_per_epoch(self) -> None:
        n = len(self.train_nodes)
        # a ragged last batch is dropped: every batch has the same seeds
        self.steps_per_epoch = max(n // max(min(self.lc.batch_nodes, n), 1),
                                   1)
        self._epoch_perm_cache: tuple[int, np.ndarray] = (-1, None)

    # ---------------- deterministic batch construction ----------------

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        cached_epoch, perm = self._epoch_perm_cache
        if cached_epoch != epoch:
            rng = np.random.default_rng((self.lc.seed, 0x5eed, epoch))
            perm = rng.permutation(self.train_nodes)
            self._epoch_perm_cache = (epoch, perm)
        return perm

    def seeds_for(self, step: int) -> np.ndarray:
        epoch, pos = divmod(step, self.steps_per_epoch)
        b = min(self.lc.batch_nodes, len(self.train_nodes))
        return self._epoch_perm(epoch)[pos * b:(pos + 1) * b]

    def batch_for(self, step: int) -> TrainBatch:
        """Pure: sample + pad + plan + upload the batch for ``step`` (no
        buffer)."""
        t0 = time.perf_counter()
        cfg, lc = self.cfg, self.lc
        sb = sample_blocks(self.g, self.seeds_for(step), lc.fanouts,
                           rng=np.random.default_rng((lc.seed, 1, step)),
                           edge_mode=self.edge_mode)
        entries, key_parts = [], []
        for blk in sb.blocks:
            sub = pad_to_nodes(blk.graph, bucket_pow2(blk.graph.num_nodes))
            ent = self.cache.get_or_build(
                sub, arch=cfg.arch, in_dim=cfg.in_dim,
                hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                edge_vals=blk.edge_vals)
            entries.append(ent)
            acfg = ent.plan.config
            key_parts.append((
                acfg.gs, acfg.gpt, acfg.ont, acfg.src_win, acfg.dt,
                acfg.variant, sub.num_nodes,
                ent.executor.sched.num_tiles,
                None if ent.executor.sched_bwd is None
                else ent.executor.sched_bwd.num_tiles))
        p0 = entries[0].executor.sched.num_nodes
        p_last = entries[-1].executor.sched.num_nodes
        # features are cast to the policy dtype on the host (bf16 halves
        # the host->device bytes; torch rounds to nearest even, as the
        # reference's ml_dtypes cast does)
        feat = torch.zeros((p0, cfg.in_dim), dtype=cfg.compute_dtype)
        feat[:len(sb.input_nodes)] = torch.from_numpy(
            self.feat[sb.input_nodes])
        labels = torch.zeros(p_last, dtype=torch.int64)
        labels[:len(sb.seeds)] = torch.from_numpy(self.labels[sb.seeds])
        mask = torch.zeros(p_last, dtype=torch.float32)
        mask[:len(sb.seeds)] = 1.0
        batch = TrainBatch(
            feat=feat.to(self.device), labels=labels.to(self.device),
            mask=mask.to(self.device), entries=entries,
            seeds=sb.seeds, num_seeds=len(sb.seeds), step=step,
            key=(cfg.arch, cfg.backend, cfg.feat_dtype, p0,
                 tuple(key_parts)),
            raw_nodes=tuple(b.num_src for b in sb.blocks),
            raw_edges=tuple(b.graph.num_edges for b in sb.blocks),
            graph_epoch=self.graph_epoch)
        self._h_sample.observe(time.perf_counter() - t0)
        self._c_batches.inc()
        return batch

    # ---------------- graph mutation ----------------

    def update_graph(self, delta) -> None:
        """Swap the resident graph at the next safe batch boundary.

        ``delta`` is a `repro_torch.graphs.delta.GraphDelta`; the new CSR
        is built here (caller's thread, ``self._cond`` not held) and handed
        to the prefetch worker, which installs it between ``batch_for``
        calls — a batch is never sampled from a half-swapped (graph, feat,
        labels) triple.  Features for new nodes come from
        ``delta.node_feat`` (zeros if absent) and labels for them are 0.
        Deltas compose in call order: a delta given while an earlier swap
        still waits for the batch in flight is applied to that pending
        snapshot, and each delta is one graph epoch.  Buffered batches are
        dropped and rebuilt from the consumer's current step, and a batch
        in flight on the old snapshot is discarded, so ``loader(step)``
        stays a pure function of the step index *per graph epoch* (the
        Trainer restart contract within an epoch of the mutation stream).
        """
        with self._update_lock:
            # only this method sets a pending swap and only its install
            # changes the resident triple, so the base read here stays
            # valid while the new snapshot is built outside ``_cond``
            with self._cond:
                if self._pending_swap is not None:
                    g, feat, labels, epoch = self._pending_swap
                else:
                    g, feat, labels, epoch = (self.g, self.feat, self.labels,
                                              self.graph_epoch)
            g2 = g.apply_delta(delta).graph
            feat2 = extend_node_features(feat, delta, g2.num_nodes)
            if g2.num_nodes > labels.shape[0]:
                labels = np.concatenate(
                    [labels, np.zeros(g2.num_nodes - labels.shape[0],
                                      np.int32)])
            with self._cond:
                self._pending_swap = (g2, feat2, labels, epoch + 1)
                if self._thread is None or self._inflight is None:
                    # no batch is being built: install now (the worker
                    # only builds with the lock released and `_inflight`
                    # set)
                    self._apply_swap_locked()
                self._cond.notify_all()

    def _apply_swap_locked(self) -> None:
        """Install a pending swap (``self._cond`` held, no batch in
        flight)."""
        if self._pending_swap is None:
            return
        self.g, self.feat, self.labels, epoch = self._pending_swap
        self._pending_swap = None
        if self._default_train_nodes:
            self.train_nodes = np.arange(self.g.num_nodes, dtype=np.int64)
        else:
            # explicit seed sets survive the mutation minus ids beyond the
            # node range
            self.train_nodes = self.train_nodes[
                self.train_nodes < self.g.num_nodes]
        self._set_steps_per_epoch()
        # buffered batches were sampled from the old snapshot: drop them
        # and restart prefetch at the step the consumer needs next (the
        # one it is blocked on, or the one after the last it took)
        self._buf.clear()
        self._head = self._resume
        self._c_swaps.inc(epoch - self.graph_epoch)
        self.graph_epoch = epoch
        self._g_epoch.set(self.graph_epoch)

    # ---------------- prefetching front ----------------

    def __call__(self, step: int) -> TrainBatch:
        if self._thread is None:
            with self._cond:
                self._apply_swap_locked()
            return self.batch_for(step)
        t0 = time.perf_counter()
        with self._cond:
            if self._err is not None:
                raise RuntimeError("sample loader worker died") from self._err
            self._last_req = self._resume = step
            # a swap waits for the batch in flight; the worker installs it
            # (and restarts at this step) as soon as that batch is done
            while self._pending_swap is not None:
                if self._err is not None:
                    raise RuntimeError(
                        "sample loader worker died") from self._err
                self._cond.wait(timeout=0.5)
            if (step not in self._buf and step != self._head
                    and step != self._inflight):
                # restart / out-of-order access (the step is neither
                # buffered, being computed, nor next in line): resync
                self._buf.clear()
                self._head = step
                self._c_resync.inc()
                self._cond.notify_all()
            while step not in self._buf:
                if self._err is not None:
                    raise RuntimeError(
                        "sample loader worker died") from self._err
                self._cond.wait(timeout=0.5)
            batch = self._buf.pop(step)
            self._resume = step + 1
            self._cond.notify_all()
        # stall = how long the step sat waiting on host-side sampling and
        # planning; ~0 means the double buffer is doing its job
        self._h_stall.observe(time.perf_counter() - t0)
        return batch

    def _worker(self):
        try:
            while True:
                with self._cond:
                    while (not self._stop
                           and len(self._buf) >= PREFETCH):
                        self._cond.wait(timeout=0.5)
                    if self._stop:
                        return
                    step = self._head
                    self._head += 1
                    self._inflight = step
                batch = self.batch_for(step)       # heavy work, lock-free
                with self._cond:
                    self._inflight = None
                    if self._stop:
                        return
                    if self._pending_swap is not None:
                        # built from the old snapshot: never handed out
                        self._apply_swap_locked()
                    elif step >= self._last_req:
                        # (a result a resync moved past is dropped: it
                        # would pin a never-consumed entry in the buffer)
                        self._buf[step] = batch
                    self._cond.notify_all()
        except BaseException as e:                 # propagate to consumer
            with self._cond:
                self._err = e
                self._cond.notify_all()

    def close(self):
        """Stop the worker and wait for it (a batch it is building is
        finished first, so no device work of the loader outlives this)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        return {"cache": self.cache.stats(),
                "steps_per_epoch": self.steps_per_epoch,
                "batches_built": int(self._c_batches.value),
                "resyncs": int(self._c_resync.value),
                "graph_epoch": self.graph_epoch,
                "graph_swaps": int(self._c_swaps.value),
                "sample_p50_ms": self._h_sample.percentile(50) * 1e3,
                "prefetch_stall_p99_ms": self._h_stall.percentile(99) * 1e3}


class SampledTrainStep:
    """``step_fn(state, batch)`` over sampled blocks, run eagerly.

    ``state = (params, opt_state)``; ``batch`` is a `TrainBatch`.  The
    reference jits one executable per shape bucket and feeds each batch's
    schedule tensors in as arguments, so batches sharing ``batch.key``
    reuse one compilation.  PyTorch runs eagerly: there is nothing to
    compile, so there is no trace count; the step runs the entries' own
    `PlanExecutor`s, whose device schedules the loader uploaded when it
    planned the batch.  ``num_buckets`` counts the distinct ``batch.key``s
    seen — the executables the reference would have compiled.  The loss
    and its gradient run through the executors' backend (on ``"cuda"``
    the backward is the kernels over each block's transposed schedule);
    then one AdamW update, as `models.gnn.make_gnn_train_step` does.
    """

    def __init__(self, cfg: GNNConfig, opt):
        if cfg.arch not in ("gcn", "gin"):
            raise ValueError(
                f"sampled training supports gcn/gin, not {cfg.arch!r}")
        self.cfg = cfg
        self.opt = opt
        self._keys: set = set()

    @property
    def num_buckets(self) -> int:
        return len(self._keys)

    def __call__(self, state, batch: TrainBatch):
        from repro_torch.optim.adamw import adamw_update

        self._keys.add(batch.key)
        execs = [ent.executor for ent in batch.entries]
        params, opt_state = state
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, metrics = gnn_block_loss(self.cfg, leaves, batch.feat,
                                       batch.labels, batch.mask, execs)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        params, opt_state, om = adamw_update(self.opt, grads, opt_state,
                                             params)
        return (params, opt_state), {**{k: v.detach()
                                        for k, v in metrics.items()}, **om}


class _RankLoader(SampledLoader):
    """Rank ``rank``'s loader of a ``world``-rank group: its step ``k``
    is the global batch ``k * world + rank``, so each rank prefetches
    only its own batches, in order."""

    def __init__(self, *args, rank: int, world: int, **kw):
        self._rank, self._world = rank, world
        super().__init__(*args, **kw)

    def batch_for(self, step: int) -> TrainBatch:
        return super().batch_for(step * self._world + self._rank)


def _r_sampled_install(r, key, g, feat, labels, cfg, lc, train_nodes):
    cfg = dataclasses.replace(cfg, device=str(r.device))
    r.state[key] = {"cfg": cfg, "loader": _RankLoader(
        g, feat, labels, cfg, lc, train_nodes=train_nodes, rank=r.rank,
        world=r.world)}


def _r_sampled_value_and_grad(r, key, pw: dict, step: int):
    from repro_torch.distributed.graph_shard import local_step_value_and_grad
    from repro_torch.distributed.ranks import from_wire, to_wire
    from repro_torch.models.gnn import gnn_block_logits
    st = r.state[key]
    cfg = st["cfg"]
    batch = st["loader"](step)
    execs = [ent.executor for ent in batch.entries]
    grads, loss, m = local_step_value_and_grad(
        lambda p: gnn_block_logits(cfg, p, batch.feat, execs),
        {k: from_wire(w, r.device) for k, w in pw.items()},
        batch.labels, batch.mask)
    out = {"work": sum(batch.raw_edges), "key": batch.key,
           "graph_epoch": batch.graph_epoch, "step": batch.step}
    if r.rank == 0:
        out.update(grads={k: to_wire(g) for k, g in grads.items()},
                   loss=float(loss), accuracy=float(m["accuracy"]))
    return out


def _r_sampled_update_graph(r, key, delta) -> None:
    r.state[key]["loader"].update_graph(delta)


def _r_sampled_close(r, key) -> dict:
    st = r.state.pop(key, None)
    if st is None:
        return {}
    st["loader"].close()
    return st["loader"].stats()


class ShardedSampledTrainStep:
    """Data-parallel sampled training over a rank group.

    Port of the reference's `ShardedSampledTrainStep` (:473).  Rank ``p``
    holds a `SampledLoader` over the graph, features and labels given
    here (sent once) and builds batch ``s * num_shards + p`` for
    optimizer step ``s`` with its own prefetch thread, so the group
    consumes ``num_shards`` loader batches a step, exactly the batches
    the reference's caller hands its step.  ``step_fn(state, step)``
    takes the STEP INDEX (drive it with ``batch_fn = lambda s: s``): each
    rank runs the forward and backward over its batch's blocks, the
    gradients are all-reduced into the gradient of the UNION batch's
    masked loss, and one AdamW update runs in the caller.

    The reference repartitions a batch whose bucket config differs from
    its step-mates' (``sampled_replans_total``), because its `shard_map`
    operands share one set of statics.  Each rank here runs its own
    schedules, so that cannot happen and there is no replan.  The
    ``sampled_step_skew`` histogram records each step's work skew
    ((max - min) / max of the raw edge counts over the ranks' batches).
    ``num_buckets`` counts the distinct batch keys seen.
    """

    def __init__(self, cfg: GNNConfig, opt, num_shards: int, *,
                 graph: CSRGraph, feat: np.ndarray, labels: np.ndarray,
                 loader: LoaderConfig,
                 train_nodes: Optional[np.ndarray] = None,
                 dist_backend: Optional[str] = None, group=None,
                 timeout: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None):
        from repro_torch.distributed.ranks import CALL_TIMEOUT_S, shard_group
        if cfg.arch not in ("gcn", "gin"):
            raise ValueError(
                f"sampled training supports gcn/gin, not {cfg.arch!r}")
        self.cfg = cfg
        self.opt = opt
        self.num_shards = num_shards
        self.device = resolve_device(cfg.device)
        self.group = group if group is not None else shard_group(
            num_shards, device=self.device, dist_backend=dist_backend,
            timeout=CALL_TIMEOUT_S if timeout is None else timeout)
        self.key = self.group.new_key("sampled")
        self._keys: set = set()
        self.last: list = []           # each rank's report of the last step
        self.loader_stats: list = []   # each rank's loader stats at close
        self.registry = registry if registry is not None else MetricsRegistry()
        self._h_skew = self.registry.histogram(
            "sampled_step_skew", unit="",
            bounds=(0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0),
            desc="per-step shard work skew: (max-min)/max of raw edge "
                 "counts over the step's loader batches")
        self.group.run(_r_sampled_install, None, self.key, graph,
                       np.ascontiguousarray(feat, dtype=np.float32),
                       np.ascontiguousarray(labels, dtype=np.int32), cfg,
                       loader, train_nodes)

    @property
    def num_buckets(self) -> int:
        return len(self._keys)

    def value_and_grad(self, params, step: int):
        """``(grads, loss, {"loss", "accuracy"})`` of step ``step``'s union
        batch, gradients all-reduced over the ranks (no update)."""
        from repro_torch.distributed.ranks import from_wire, to_wire
        pw = {k: to_wire(v) for k, v in params.items()}
        reps = self.group.run(_r_sampled_value_and_grad, None, self.key, pw,
                              int(step))
        work = [rep["work"] for rep in reps]
        self._h_skew.observe((max(work) - min(work)) / max(max(work), 1))
        self._keys.update(rep["key"] for rep in reps)
        self.last = reps
        grads = {k: from_wire(w, self.device)
                 for k, w in reps[0]["grads"].items()}
        loss = torch.tensor(reps[0]["loss"], device=self.device)
        acc = torch.tensor(reps[0]["accuracy"], device=self.device)
        return grads, loss, {"loss": loss, "accuracy": acc}

    def __call__(self, state, step: int):
        from repro_torch.optim.adamw import adamw_update
        params, opt_state = state
        grads, _, metrics = self.value_and_grad(params, step)
        params, opt_state, om = adamw_update(self.opt, grads, opt_state,
                                             params)
        return (params, opt_state), {**metrics, **om}

    def update_graph(self, delta) -> None:
        """Hand a `GraphDelta` to every rank's loader (swapped in at its
        next batch boundary, `SampledLoader.update_graph`)."""
        self.group.run(_r_sampled_update_graph, None, self.key, delta)

    def close(self) -> None:
        """Stop the ranks' loaders (their stats land in
        ``loader_stats``) and free their state."""
        if self.group.alive and not self.loader_stats:
            self.loader_stats = self.group.run(_r_sampled_close, None,
                                               self.key)
