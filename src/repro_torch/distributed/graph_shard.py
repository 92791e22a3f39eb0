"""Multi-rank halo-exchange graph execution over a sharded `Plan`.

Port of `src/repro/distributed/graph_shard.py` (`ShardedExecutor`,
`local_step_value_and_grad`, `make_sharded_logits_fn`,
`make_sharded_train_step`, the shard gauges) on `torch.distributed`.

Dataflow, per aggregation, as in the reference: rank ``p`` owns the
contiguous node range ``[p n_local, (p+1) n_local)`` of the parent plan
(`repro_torch.core.shard`), and each layer

    all-gather activations  ->  local group-aggregate over the shard's
    sub-schedule  ->  keep the owned rows

The all-gather IS the halo exchange (every shard's halo is a subset of
the gathered matrix).  `gather_rows` is a `torch.autograd.Function` whose
backward is the reduce-scatter (the reference's psum-scatter), so the
backward pass returns feature cotangents to their owner ranks, while the
aggregation itself differentiates through each sub-plan's TRANSPOSED
schedule (`kernels.ops`): forward and backward both run the
group-aggregate kernels, on every rank.

Process model (port-only, `repro_torch.distributed.ranks`): the
reference is one controller over a ``shard_map`` mesh.  Here the entry
points keep its signatures and are called from one process; behind them
a group of ``P`` rank processes each holds its own sub-plan, sent once,
and the rows of the inputs it owns, sent once per new input (an input is
known by identity and version).  Per call only parameters, cotangents
and results cross the pipe.  AdamW runs once per step, in the caller,
on the all-reduced gradient.

The reference stacks the per-shard schedules into ``(P, ...)`` operands
(`stack_shard_args` / `squeeze_shard_args`) because one compiled
executable serves every shard.  Each rank here runs its own schedules, so
that convention has no counterpart.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Optional

import torch

from repro_torch.distributed.ranks import (CALL_TIMEOUT_S, Rank,
                                           all_gather_rows, all_reduce_,
                                           from_wire, reduce_scatter_rows,
                                           shard_group, to_wire)
from repro_torch.obs import MetricsRegistry

__all__ = ["ShardedExecutor", "gather_rows", "local_step_value_and_grad",
           "make_sharded_logits_fn", "make_sharded_train_step",
           "shard_group"]


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks whose transpose is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x):
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Inside a rank: every rank's ``x`` (n_local, D) stacked in rank
    order, (P n_local, D); differentiable (the halo exchange)."""
    return _GatherRows.apply(x)


def local_step_value_and_grad(logits_of, params, labels_l, mask_l):
    """The shared per-rank loss/grad body of every sharded train step.

    ``logits_of(params) -> (n_local, C)`` is this rank's forward (the
    full-graph layer chain or the sampled block chain).  Computes the
    masked-mean cross-entropy of the GLOBAL batch (the mask count is
    all-reduced first, so each rank's loss share sums to the global
    loss), backpropagates it on this rank, and all-reduces gradients and
    metrics (one collective) to replicated values.

    Returns ``(grads, loss, {"loss", "accuracy"})`` (0-d tensors).
    """
    den = all_reduce_(mask_l.float().sum().reshape(1)).clamp_min(1.0)[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    lg = logits_of(leaves)
    logp = torch.log_softmax(lg, dim=-1)
    per = -torch.gather(logp, 1, labels_l.long()[:, None])[:, 0]
    loss_p = (per * mask_l).sum() / den
    grads = torch.autograd.grad(loss_p, list(leaves.values()))
    acc_p = ((lg.argmax(-1) == labels_l) * mask_l).sum() / den
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss_p.detach().reshape(1), acc_p.reshape(1)])
    all_reduce_(flat)
    out, off = {}, 0
    for k, g in zip(leaves, grads):
        out[k] = flat[off:off + g.numel()].reshape(g.shape)
        off += g.numel()
    loss, acc = flat[off], flat[off + 1]
    return out, loss, {"loss": loss, "accuracy": acc}


def _portable(plan):
    """The sub-plan without the caches of the caller's device schedules
    (fresh object: only the dataclass fields are pickled)."""
    return dataclasses.replace(plan, tuner=None)


def _record_shard_gauges(registry: MetricsRegistry, shards, *,
                         nbytes: Optional[int] = None) -> None:
    """Partition-shape gauges shared by every sharded entry point: edge
    balance across shards, per-shard halo node counts, and, with the
    bytes of one feature row, per-shard halo bytes."""
    st = shards.stats()
    registry.gauge(
        "shard_edge_balance",
        desc="max/mean edges per shard (1.0 = perfect)").set(
        st["edge_balance"])
    for p, h in enumerate(shards.halo):
        registry.gauge(
            "shard_halo_nodes", labels={"shard": p},
            desc="remote source nodes shard p reads (selective-"
                 "exchange lower bound)").set(len(h))
        if nbytes is not None:
            registry.gauge(
                "shard_halo_bytes", labels={"shard": p},
                desc="halo nodes x feature dim x dtype bytes").set(
                len(h) * nbytes)


def _row_slices(x: torch.Tensor, spec, dtype=None) -> list:
    """``x`` (n, ...) zero-padded to ``spec.padded_nodes`` rows, at
    ``dtype``, as one wire slice per rank."""
    if dtype is not None:
        x = x.to(dtype)
    pad = spec.padded_nodes - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    n = spec.n_local
    return [to_wire(x[p * n:(p + 1) * n]) for p in range(spec.num_shards)]


# ---------------------------------------------------------------------------
# rank side

def _r_install(r: Rank, key, plan, backend: str, extra: dict) -> None:
    from repro_torch.core.aggregate import PlanExecutor
    st = r.state.setdefault(key, {})
    st.update(extra)
    st["plan"] = plan
    st["ex"] = PlanExecutor(plan, backend=backend, device=r.device)


def _r_set(r: Rank, key, name: str, wire) -> None:
    r.state[key][name] = from_wire(wire, r.device)


def _r_agg_forward(r: Rank, key, call: int, stale: list, grad_x: bool,
                   grad_ev: bool, xw, evw):
    """One aggregation on this rank.  When a gradient is wanted, the
    tensors backward needs are kept under the call's id ``call`` (so any
    number of calls may be pending backward at once); ``stale`` lists
    the ids of earlier calls whose autograd nodes died unused."""
    st = r.state[key]
    ex = st["ex"]
    saved = st.setdefault("saved", {})
    for c in stale:
        saved.pop(c, None)
    x = from_wire(xw, r.device).requires_grad_(grad_x)
    ev = from_wire(evw, r.device)
    if ev is not None:
        ev.requires_grad_(grad_ev)
    with torch.set_grad_enabled(grad_x or grad_ev):
        full = gather_rows(x)
        out = (ex(full) if ev is None
               else ex.aggregate_edges(full, ev))[:x.shape[0]]
    if grad_x or grad_ev:
        saved[call] = (x, ev, out)
    return to_wire(out)


def _r_agg_backward(r: Rank, key, call: int, e_max: int, ranges: list, gw):
    """Feature and edge-value gradients of forward call ``call``,
    replicated on every rank (all-gathered); rank 0 returns them."""
    saved = r.state[key].get("saved", {})
    if call not in saved:
        raise RuntimeError(
            f"sharded aggregation call {call}: no saved tensors (its "
            f"backward already ran; a second backward through one call "
            f"is not supported)")
    x, ev, out = saved.pop(call)
    g = from_wire(gw, r.device).to(out.dtype)
    wrt = [t for t in (x, ev) if t is not None and t.requires_grad]
    grads = dict(zip([id(t) for t in wrt],
                     torch.autograd.grad(out, wrt, g, allow_unused=True)))
    gx = gev = None
    if x.requires_grad:
        gx_l = grads[id(x)]
        gx = all_gather_rows(torch.zeros_like(x) if gx_l is None else gx_l)
    if ev is not None and ev.requires_grad:
        ge_l = grads[id(ev)]
        ge_l = torch.zeros_like(ev) if ge_l is None else ge_l
        padded = torch.zeros(e_max, dtype=ge_l.dtype, device=ge_l.device)
        padded[:ge_l.shape[0]] = ge_l
        stacked = all_gather_rows(padded[None])
        gev = torch.cat([stacked[p, :hi - lo]
                         for p, (lo, hi) in enumerate(ranges)])
    return (to_wire(gx), to_wire(gev)) if r.rank == 0 else None


class _ShardedAggregate(torch.autograd.Function):
    """The caller's autograd node around one sharded aggregation."""

    @staticmethod
    def forward(ctx, feat, edge_values, ex, grad_x, grad_ev):
        ctx.ex = ex
        ctx.feat_dtype = feat.dtype
        ctx.ev_dtype = None if edge_values is None else edge_values.dtype
        ctx.call = next(ex._calls)
        xs = _row_slices(feat, ex.spec, ex.feat_dtype)
        evs = [None] * ex.spec.num_shards
        if edge_values is not None:
            ev = edge_values.float()
            evs = [to_wire(ev[lo:hi]) for lo, hi in ex.shards.edge_ranges]
        outs = ex.group.run(_r_agg_forward, list(zip(xs, evs)), ex.key,
                            ctx.call, ex._take_stale(), grad_x, grad_ev)
        if grad_x or grad_ev:
            # a node that dies without its backward frees the ranks' slot
            # at the executor's next call
            ctx.fin = weakref.finalize(ctx, ex._stale.append, ctx.call)
        out = torch.cat([from_wire(o, feat.device) for o in outs])
        return out[:ex.spec.num_nodes]

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        if hasattr(ctx, "fin"):
            ctx.fin.detach()
        e_max = max((hi - lo for lo, hi in ex.shards.edge_ranges), default=0)
        res = ex.group.run(_r_agg_backward,
                           [(w,) for w in _row_slices(g, ex.spec)], ex.key,
                           ctx.call, e_max, list(ex.shards.edge_ranges))[0]
        gx, gev = (from_wire(w, g.device) for w in res)
        if gx is not None:
            gx = gx[:ex.spec.num_nodes].to(ctx.feat_dtype)
        if gev is not None:
            gev = gev.to(ctx.ev_dtype)
        return gx, gev, None, None, None


class ShardedExecutor:
    """Multi-rank counterpart of `core.aggregate.PlanExecutor`.

    ``__call__(feat)`` / ``aggregate_edges(feat, edge_values)`` take and
    return tensors in the PARENT plan's node order and full node count,
    on the caller's device; sharding, padding and the halo exchange are
    internal.  Differentiable with respect to features (and dynamic edge
    values) whenever the parent plan carried a backward pair or the
    backend is ``"torch"``: the gradients are the single-device ones,
    replicated on every rank.  Each call's saved tensors are kept on the
    ranks under its own id, so calls compose (``ex(ex(x))``, several
    layers) and backpropagate in any order, each once.  Features enter
    the exchange at the parent plan's ``feat_dtype`` (bfloat16 halves
    the all-gather bytes).

    Example
    -------
    >>> plan = plan_for(g, arch="gcn", edge_vals=vals, with_backward=True)
    >>> ex = ShardedExecutor(plan.shards(4), backend="torch", device="cpu")
    >>> out = ex(feat)                    # == PlanExecutor(plan)(feat)
    """

    def __init__(self, shards, *, backend: str = "cuda", device="cuda",
                 dist_backend: Optional[str] = None, group=None,
                 timeout: float = CALL_TIMEOUT_S,
                 registry: Optional[MetricsRegistry] = None):
        self.shards = shards
        self.spec = shards.spec
        self.backend = backend
        self.group = group if group is not None else shard_group(
            shards.spec.num_shards, device=device, dist_backend=dist_backend,
            timeout=timeout)
        self.feat_dtype = getattr(torch, shards.plans[0].config.feat_dtype)
        self.key = self.group.new_key("executor")
        self._calls = itertools.count()
        self._stale: list = []
        self.group.run(_r_install, [(self.key, _portable(p), backend, {})
                                    for p in shards.plans])
        self.registry = registry if registry is not None else MetricsRegistry()
        _record_shard_gauges(self.registry, shards)
        self._halo_bytes_dim = None

    def _record_halo_bytes(self, dim: int) -> None:
        """Per-shard halo traffic of a selective exchange at this feature
        width: the lower bound the all-gather transport is compared
        against."""
        if self._halo_bytes_dim != dim:
            self._halo_bytes_dim = dim
            _record_shard_gauges(self.registry, self.shards,
                                 nbytes=self.feat_dtype.itemsize * dim)

    def _take_stale(self) -> list:
        """The ids of calls whose autograd nodes died before backward."""
        out = []
        while self._stale:
            out.append(self._stale.pop())
        return out

    def __call__(self, feat: torch.Tensor) -> torch.Tensor:
        self._record_halo_bytes(int(feat.shape[1]))
        grad = torch.is_grad_enabled() and feat.requires_grad
        return _ShardedAggregate.apply(feat, None, self, grad, False)

    def aggregate_edges(self, feat: torch.Tensor,
                        edge_values: torch.Tensor) -> torch.Tensor:
        """Dynamic per-edge weights in the PARENT graph's CSR edge order
        (the GAT-type path).  Rank p takes its contiguous slice
        ``edge_ranges[p]``; the edge-value gradient comes back in the
        parent's order."""
        self._record_halo_bytes(int(feat.shape[1]))
        on = torch.is_grad_enabled()
        return _ShardedAggregate.apply(
            feat, edge_values, self, on and feat.requires_grad,
            on and edge_values.requires_grad)

    def close(self) -> None:
        """Free the ranks' copies of this executor's sub-plans."""
        self.group.drop(self.key)


# ---------------------------------------------------------------------------
# the sharded model: logits and train step

def _r_install_model(r: Rank, key, plan, cfg) -> None:
    _r_install(r, key, plan, cfg.backend,
               {"cfg": dataclasses.replace(cfg, device=str(r.device))})


def _params(pw: dict, device) -> dict:
    return {k: from_wire(w, device) for k, w in pw.items()}


def _local_logits(st: dict, params: dict) -> torch.Tensor:
    from repro_torch.models.gnn import gnn_sharded_logits
    return gnn_sharded_logits(st["cfg"], params, st["feat"], st["ex"])


def _r_logits(r: Rank, key, pw: dict):
    st = r.state[key]
    with torch.no_grad():
        return to_wire(_local_logits(st, _params(pw, r.device)))


def _r_value_and_grad(r: Rank, key, pw: dict):
    st = r.state[key]
    grads, loss, m = local_step_value_and_grad(
        lambda p: _local_logits(st, p), _params(pw, r.device),
        st["labels"], st["mask"])
    if r.rank:
        return None
    return ({k: to_wire(g) for k, g in grads.items()}, float(loss),
            float(m["accuracy"]))


def _r_profile_step(r: Rank, key, pw: dict) -> dict:
    """One forward + backward of the sharded loss on this rank, timed:
    the step's span and the collectives' spans inside it (CUDA events on
    the card, the host clock on the CPU)."""
    from repro_torch.distributed.ranks import collective_ms, collective_timing
    st = r.state[key]
    on_card = r.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
    else:
        h0 = time.perf_counter()
    collective_timing(True)
    try:
        local_step_value_and_grad(lambda p: _local_logits(st, p),
                                  _params(pw, r.device), st["labels"],
                                  st["mask"])
        if on_card:
            t1.record()
            t1.synchronize()
            step_ms = t0.elapsed_time(t1)
        else:
            step_ms = (time.perf_counter() - h0) * 1e3
        coll = collective_ms()
    finally:
        collective_timing(False)
    return {"rank": r.rank, "step_ms": step_ms, "collective_ms": coll,
            "other_ms": step_ms - coll}


class ShardedModel:
    """The caller's handle of one full-graph GCN/GIN split over a rank
    group: each rank holds its sub-plan and its rows of the inputs.
    `make_sharded_logits_fn` and `make_sharded_train_step` return
    callables over one of these (as ``.model``)."""

    def __init__(self, cfg, shards, *, group=None,
                 dist_backend: Optional[str] = None,
                 timeout: float = CALL_TIMEOUT_S,
                 registry: Optional[MetricsRegistry] = None):
        if cfg.arch not in ("gcn", "gin"):
            raise NotImplementedError(
                f"sharded forward supports gcn/gin, not {cfg.arch!r}")
        from repro_torch.device import resolve_device
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.group = group if group is not None else shard_group(
            shards.spec.num_shards, device=self.device,
            dist_backend=dist_backend, timeout=timeout)
        self.key = self.group.new_key("model")
        self.shards = shards
        self.spec = shards.spec
        self._sent: dict = {}
        self.group.run(_r_install_model, [(self.key, _portable(p), cfg)
                                          for p in shards.plans])
        if registry is not None:
            _record_shard_gauges(
                registry, shards,
                nbytes=cfg.compute_dtype.itemsize * cfg.in_dim)

    def _send_rows(self, name: str, t, dtype) -> None:
        """Send each rank its rows of ``t`` unless this very tensor, at
        this version, went last time."""
        version = getattr(t, "_version", 0)
        prev = self._sent.get(name)
        if prev is not None and prev[0] is t and prev[1] == version:
            return
        if t is None:                    # an absent mask: every real row
            src = torch.ones(self.spec.num_nodes, dtype=dtype)
        else:
            src = t
        self.group.run(_r_set, [(self.key, name, w) for w in
                                _row_slices(src, self.spec, dtype)])
        self._sent[name] = (t, version)

    def _send_batch(self, batch: dict) -> None:
        self._send_rows("feat", batch["feat"], self.cfg.compute_dtype)
        self._send_rows("labels", batch["labels"], torch.int64)
        self._send_rows("mask", batch.get("mask"), torch.float32)

    def _pw(self, params: dict) -> dict:
        return {k: to_wire(v) for k, v in params.items()}

    def logits(self, params: dict, feat: torch.Tensor) -> torch.Tensor:
        """(num_nodes, num_classes) float32 on ``cfg.device``, in the
        parent plan's node order."""
        self._send_rows("feat", feat, self.cfg.compute_dtype)
        outs = self.group.run(_r_logits, None, self.key, self._pw(params))
        return torch.cat([from_wire(o, self.device)
                          for o in outs])[:self.spec.num_nodes]

    def value_and_grad(self, params: dict, batch: dict):
        """``(grads, loss, {"loss", "accuracy"})`` of the masked loss over
        the whole graph (``batch`` as `models.gnn.make_gnn_train_step`
        takes it), gradients all-reduced over the ranks."""
        self._send_batch(batch)
        gw, loss, acc = self.group.run(_r_value_and_grad, None, self.key,
                                       self._pw(params))[0]
        grads = {k: from_wire(w, self.device) for k, w in gw.items()}
        loss_t = torch.tensor(loss, dtype=torch.float32, device=self.device)
        acc_t = torch.tensor(acc, dtype=torch.float32, device=self.device)
        return grads, loss_t, {"loss": loss_t, "accuracy": acc_t}

    def profile_step(self, params: dict, batch: dict) -> list:
        """Each rank's time for one forward + backward of the masked loss
        (no update): ``[{"rank", "step_ms", "collective_ms",
        "other_ms"}]``, ``other_ms`` being the kernels, projections and
        loss between the collectives."""
        self._send_batch(batch)
        return self.group.run(_r_profile_step, None, self.key,
                              self._pw(params))

    def update_shards(self, shards2) -> list:
        """Adopt ``shards2`` (`PlanShards.apply_delta`'s result on this
        model's split): a sub-plan that is the same `Plan` object as
        before is not sent, every other is sent again.  Returns the ranks
        sent again."""
        same = shards2.spec.n_local == self.spec.n_local
        plans = [None if same and new is old
                 else (self.key, _portable(new), self.cfg)
                 for new, old in zip(shards2.plans, self.shards.plans)]
        resent = [p for p, a in enumerate(plans) if a is not None]
        if resent:
            self.group.run(_r_reinstall, [(a,) for a in plans])
        self.shards, self.spec = shards2, shards2.spec
        self._sent.clear()                  # row slices follow the spec
        return resent

    def close(self) -> None:
        self.group.drop(self.key)


def _r_reinstall(r: Rank, args) -> None:
    if args is not None:
        _r_install_model(r, *args)


def make_sharded_logits_fn(cfg, shards, *, group=None,
                           dist_backend: Optional[str] = None,
                           timeout: float = CALL_TIMEOUT_S,
                           registry: Optional[MetricsRegistry] = None):
    """``logits_fn(params, feat) -> (num_nodes, num_classes)`` running the
    full-graph GCN/GIN forward sharded P ways over a rank group (parent
    plan node order in and out: numerically the single-device
    `GNNModel.logits`).  ``logits_fn.model`` is the `ShardedModel`."""
    model = ShardedModel(cfg, shards, group=group, dist_backend=dist_backend,
                         timeout=timeout, registry=registry)

    def logits_fn(params, feat):
        return model.logits(params, feat)

    logits_fn.model = model
    return logits_fn


class ShardedTrainStep:
    """`Trainer`-shaped ``step_fn(state, batch)`` for sharded full-graph
    training: per-rank forward/backward over the shard sub-schedules, the
    masked loss over the global mask, gradients all-reduced, then one
    AdamW update in the caller.  ``batch`` is the single-device contract
    (``{"feat", "labels"[, "mask"]}`` in the parent plan's node order);
    the padded tail rows are masked out, so the loss matches the
    single-device step.  Its inputs go to the ranks once (by identity)."""

    def __init__(self, model: ShardedModel, opt):
        self.model = model
        self.opt = opt

    def __call__(self, state, batch):
        from repro_torch.optim.adamw import adamw_update
        params, opt_state = state
        grads, _, metrics = self.model.value_and_grad(params, batch)
        params, opt_state, om = adamw_update(self.opt, grads, opt_state,
                                             params)
        return (params, opt_state), {**metrics, **om}

    def close(self) -> None:
        self.model.close()


def make_sharded_train_step(cfg, shards, opt, *, group=None,
                            dist_backend: Optional[str] = None,
                            timeout: float = CALL_TIMEOUT_S,
                            registry: Optional[MetricsRegistry] = None
                            ) -> ShardedTrainStep:
    """The `ShardedTrainStep` of ``cfg`` over ``shards`` (see there)."""
    return ShardedTrainStep(
        ShardedModel(cfg, shards, group=group, dist_backend=dist_backend,
                     timeout=timeout, registry=registry), opt)
