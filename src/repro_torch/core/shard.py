"""Shardable plans: split one `Plan` into per-device sub-plans (NeuGraph-
style partition-based dataflow, adapted to the static group schedule).

Port of `src/repro/core/shard.py` (`ShardSpec`, `shard_ranges`,
`halo_sources`, `shard_graph`, `PlanShards` with `apply_delta` and
`stats`, `shard_plan`, `update_shards`); schedules, halos, edge ranges
and stats are bit-equal to the reference's (the same numpy code).

A graph is split into ``P`` CONTIGUOUS node-range shards: shard ``p`` owns
output rows ``[p*n_local, (p+1)*n_local)``.  Contiguity is deliberate —
after community renumbering (§6.1) consecutive ids are neighbors, so
contiguous ranges are dense sub-communities and the halo (the set of
remote source nodes a shard reads) stays small.  Each shard gets a full
sub-`Plan`: its rows' adjacency partitioned under the parent's tuned
`AggConfig`, with GLOBAL source ids (the kernel gathers from the
all-gathered feature matrix) and, for training, the transposed backward
pair.  All shards are padded to one tile count so their schedules stack
into uniform per-device operands.

This module is pure host-side numpy, like the rest of the planning
stack.  On one device a sub-plan runs through `PlanExecutor` over the
whole feature matrix zero-padded to ``spec.padded_nodes`` rows (what the
all-gather hands each device), keeping output rows ``[0, n_local)``;
the per-shard feature gradients sum to the unsharded one.  The
multi-device execution (the reference's
`repro.distributed.graph_shard`: mesh, all-gather, psum-scatter) is not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.partition import (GroupPartition,
                                        pad_partition_tiles, partition_graph,
                                        transpose_graph)
from repro_torch.core.plan import Plan
from repro_torch.graphs.csr import CSRGraph, sorted_unique

__all__ = ["PlanShards", "ShardSpec", "halo_sources", "shard_graph",
           "shard_plan", "update_shards"]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Geometry of a contiguous node-range split."""

    num_shards: int
    num_nodes: int        # real node count of the parent graph
    n_local: int          # uniform rows per shard (padded_nodes / num_shards)

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.n_local


def shard_ranges(num_nodes: int, num_shards: int) -> ShardSpec:
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    n_local = -(-num_nodes // num_shards)
    return ShardSpec(num_shards=num_shards, num_nodes=num_nodes,
                     n_local=n_local)


def halo_sources(g: CSRGraph, spec: ShardSpec) -> list[np.ndarray]:
    """Per-shard halo: the sorted REMOTE source ids shard p's rows read
    (NeuGraph's replicated "halo" vertices).  The reference's executor
    exchanges features by all-gather, so the halo is advisory — it is the
    lower bound a selective (send-only-what's-read) exchange would move,
    reported in `PlanShards.stats()` so reorder quality is observable."""
    out = []
    for p in range(spec.num_shards):
        lo, hi = p * spec.n_local, (p + 1) * spec.n_local
        e_lo, e_hi = (g.indptr[min(lo, g.num_nodes)],
                      g.indptr[min(hi, g.num_nodes)])
        srcs = sorted_unique(g.indices[e_lo:e_hi])
        out.append(srcs[(srcs < lo) | (srcs >= hi)].astype(np.int64))
    return out


def shard_graph(g: CSRGraph, spec: ShardSpec,
                edge_vals: Optional[np.ndarray] = None):
    """Split ``g`` into per-shard sub-CSRs.

    Each sub-graph is SQUARE over ``spec.padded_nodes`` nodes: rows
    ``[0, n_local)`` hold shard p's adjacency (dst relabelled to local ids,
    source ids kept GLOBAL), every other row is empty.  That square-over-N
    shape is exactly the bipartite-block convention the sampled trainer
    already uses — the kernel's feature operand is the full (gathered)
    matrix, its output is sliced to the local rows, and unvisited output
    blocks are masked by `kernels.ops._aggregate_impl`.

    Returns ``(subs, sub_vals, edge_ranges)`` where ``edge_ranges[p] =
    (e_lo, e_hi)`` is shard p's contiguous slice of the parent's CSR edge
    array (dynamic per-edge values shard by slicing with it).
    """
    n, n_pad = g.num_nodes, spec.padded_nodes
    subs, sub_vals, edge_ranges = [], [], []
    for p in range(spec.num_shards):
        lo, hi = p * spec.n_local, min((p + 1) * spec.n_local, n)
        lo = min(lo, n)
        e_lo, e_hi = int(g.indptr[lo]), int(g.indptr[hi])
        indptr = np.full(n_pad + 1, e_hi - e_lo, dtype=np.int64)
        indptr[: hi - lo + 1] = g.indptr[lo:hi + 1] - e_lo
        indptr[0] = 0
        subs.append(CSRGraph(indptr, g.indices[e_lo:e_hi].copy()))
        sub_vals.append(None if edge_vals is None
                        else np.asarray(edge_vals,
                                        dtype=np.float32)[e_lo:e_hi])
        edge_ranges.append((e_lo, e_hi))
    return subs, sub_vals, edge_ranges


@dataclasses.dataclass
class PlanShards:
    """A `Plan` split for P-way halo-exchange execution.

    ``plans[p]`` is shard p's sub-`Plan` (same `AggConfig`, uniform tile
    count and statics across shards, backward pair iff the parent carried
    one).  ``halo[p]`` is the remote source set (see `halo_sources`).
    ``edge_ranges[p]`` slices dynamic per-edge values out of the parent's
    CSR edge order.  The parent's renumber perm stays on ``parent`` — data
    enters/leaves in the parent plan's node order.
    """

    parent: Plan
    spec: ShardSpec
    plans: list
    halo: list
    edge_ranges: list

    @property
    def num_shards(self) -> int:
        return self.spec.num_shards

    def apply_delta(self, delta, **kwargs) -> "PlanShards":
        """Apply a `GraphDelta` to the parent plan (incrementally —
        `Plan.apply_delta`) and recompute only the sub-plans whose node
        ranges intersect the dirty set; every other shard's `Plan` OBJECT
        is reused, keeping its device-resident schedules.  Returns a new
        `PlanShards`."""
        parent2, res = self.parent.apply_delta(delta, return_details=True,
                                               **kwargs)
        return update_shards(self, parent2, res.dirty_rows)

    def stats(self) -> dict:
        """Shard balance + halo metrics (the multi-device analogue of
        `partition_stats`): edge balance drives per-device work, halo
        fraction drives exchange traffic a selective transport would move."""
        edges = np.array([p.partition.num_edges for p in self.plans])
        halo = np.array([len(h) for h in self.halo])
        local_src = np.array(
            [max(len(sorted_unique(p.graph.indices)), 1) for p in self.plans])
        return {
            "num_shards": self.spec.num_shards,
            "n_local": self.spec.n_local,
            "edges_per_shard": edges.tolist(),
            "edge_balance": float(edges.max() / max(edges.mean(), 1e-9)),
            "halo_per_shard": halo.tolist(),
            "halo_frac": (halo / local_src).tolist(),
            "tiles_per_shard": int(self.plans[0].partition.num_tiles),
        }


def shard_plan(plan: Plan, num_shards: int, *,
               with_backward: Optional[bool] = None) -> PlanShards:
    """Split ``plan`` into ``num_shards`` contiguous node-range sub-plans.

    Every shard is partitioned under the parent's tuned config, then padded
    to the max tile count across shards (forward and backward separately)
    so the schedule tensors stack into uniform per-device operands.  Static
    per-edge values travel from the parent's schedule (recovered to CSR edge
    order via ``edge_slot``/``edge_pos``); ``with_backward`` defaults to
    whether the parent carried a backward pair.
    """
    g, cfg = plan.graph, plan.config
    if with_backward is None:
        with_backward = plan.partition_bwd is not None
    spec = shard_ranges(g.num_nodes, num_shards)
    edge_vals = plan.partition.edge_values_csr()
    # all-ones is the partitioner's own default; keep None for fidelity
    if edge_vals is not None and np.all(edge_vals == 1.0):
        edge_vals = None
    subs, sub_vals, edge_ranges = shard_graph(g, spec, edge_vals)

    parts, parts_bwd, edge_perms = [], [], []
    for sub, vals in zip(subs, sub_vals):
        parts.append(partition_graph(sub, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                                     src_win=cfg.src_win, edge_vals=vals))
        if with_backward:
            gT, vals_t, eperm = transpose_graph(sub, vals)
            parts_bwd.append(partition_graph(
                gT, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                src_win=cfg.src_win, edge_vals=vals_t))
            edge_perms.append(eperm)
        else:
            parts_bwd.append(None)
            edge_perms.append(None)

    t_fwd = max(p.num_tiles for p in parts)
    parts = [pad_partition_tiles(p, t_fwd) for p in parts]
    if with_backward:
        t_bwd = max(p.num_tiles for p in parts_bwd)
        parts_bwd = [pad_partition_tiles(p, t_bwd) for p in parts_bwd]

    plans = [
        Plan(graph=sub, partition=pf, config=cfg, graph_props=None,
             arch=plan.arch, perm=None, tuner=None, stats={},
             reduce_dim_first=plan.reduce_dim_first,
             partition_bwd=pb, edge_perm_bwd=ep, epoch=plan.epoch)
        for sub, pf, pb, ep in zip(subs, parts, parts_bwd, edge_perms)
    ]
    return PlanShards(parent=plan, spec=spec, plans=plans,
                      halo=halo_sources(g, spec), edge_ranges=edge_ranges)


def _shard_sub_plan(parent: Plan, sub: CSRGraph, vals, with_backward: bool):
    """One shard's sub-plan under the parent config (unpadded tiles)."""
    cfg = parent.config
    part = partition_graph(sub, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                           src_win=cfg.src_win, edge_vals=vals)
    part_bwd = eperm = None
    if with_backward:
        gT, vals_t, eperm = transpose_graph(sub, vals)
        part_bwd = partition_graph(gT, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                                   src_win=cfg.src_win, edge_vals=vals_t)
    return Plan(graph=sub, partition=part, config=cfg, graph_props=None,
                arch=parent.arch, perm=None, tuner=None, stats={},
                reduce_dim_first=parent.reduce_dim_first,
                partition_bwd=part_bwd, edge_perm_bwd=eperm,
                epoch=parent.epoch)


def _patch_shard_values(plan_sub: Plan, vals: Optional[np.ndarray]) -> Plan:
    """Value-only shard refresh: the sub-graph's STRUCTURE is unchanged but
    its per-edge values are not (GCN degree normalization reaches rows the
    delta never touched structurally).  Rebuilds just the (T, gpt, gs)
    value tensors through the existing slot maps — no repartitioning."""
    p = plan_sub.partition
    flat = np.zeros((p.num_tiles * p.gpt, p.gs), np.float32)
    flat[p.edge_slot, p.edge_pos] = (1.0 if vals is None
                                     else np.asarray(vals, np.float32))
    part = dataclasses.replace(
        p, edge_val=flat.reshape(p.num_tiles, p.gpt, p.gs))
    pb = plan_sub.partition_bwd
    if pb is not None:
        vt = (np.ones(pb.num_edges, np.float32) if vals is None
              else np.asarray(vals, np.float32))[plan_sub.edge_perm_bwd]
        flatb = np.zeros((pb.num_tiles * pb.gpt, pb.gs), np.float32)
        flatb[pb.edge_slot, pb.edge_pos] = vt
        pb = dataclasses.replace(
            pb, edge_val=flatb.reshape(pb.num_tiles, pb.gpt, pb.gs))
    return dataclasses.replace(plan_sub, partition=part, partition_bwd=pb)


def update_shards(shards: PlanShards, parent2: Plan,
                  dirty_rows: np.ndarray) -> PlanShards:
    """Incremental re-shard: given the updated parent plan and the delta's
    dirty destination rows (both from ``Plan.apply_delta(...,
    return_details=True)``, ids in the parent's plan order), rebuild ONLY
    the sub-plans whose node range intersects the dirty set.

    A shard's sub-plan content — forward AND backward, halo included —
    depends only on its own rows' adjacency and values (the backward pair
    transposes the shard-local sub-graph), so structurally clean shards are
    reused as the SAME `Plan` objects: their cached `DeviceSchedule`s stay
    device-resident and their tile shapes stay uniform.  Clean shards whose
    per-edge VALUES changed (GCN normalization after a neighbor's degree
    moved) get a value-only tensor refresh.  If
    the mutated graph outgrew the shard geometry (``num_nodes >
    spec.padded_nodes``), the whole split is recomputed from scratch."""
    spec = shards.spec
    g2 = parent2.graph
    n2 = g2.num_nodes
    if n2 > spec.padded_nodes:
        return shard_plan(parent2, spec.num_shards)
    spec2 = dataclasses.replace(spec, num_nodes=n2)
    with_backward = parent2.partition_bwd is not None

    edge_vals = parent2.partition.edge_values_csr()
    if edge_vals is not None and np.all(edge_vals == 1.0):
        edge_vals = None
    subs, sub_vals, edge_ranges = shard_graph(g2, spec2, edge_vals)

    dirty = np.zeros(spec.num_shards, dtype=bool)
    if len(dirty_rows):
        dirty[np.asarray(dirty_rows, np.int64) // spec.n_local] = True

    plans2, halo2 = [], []
    for p in range(spec.num_shards):
        old = shards.plans[p]
        if not dirty[p]:
            halo2.append(shards.halo[p])      # clean rows read the same srcs
            new_vals, old_vals = sub_vals[p], old.partition.edge_values_csr()
            if new_vals is None:
                same = old_vals is None or bool(np.all(old_vals == 1.0))
            else:
                same = old_vals is not None and np.array_equal(new_vals,
                                                               old_vals)
            plans2.append(old if same
                          else _patch_shard_values(old, new_vals))
            continue
        plans2.append(_shard_sub_plan(parent2, subs[p], sub_vals[p],
                                      with_backward))
        lo, hi = p * spec.n_local, (p + 1) * spec.n_local
        e_lo, e_hi = int(g2.indptr[min(lo, n2)]), int(g2.indptr[min(hi, n2)])
        srcs = sorted_unique(g2.indices[e_lo:e_hi])
        halo2.append(srcs[(srcs < lo) | (srcs >= hi)].astype(np.int64))

    # uniformize tile counts; clean shards keep their objects when the
    # rebuilt shards fit under the existing padding
    t_f = max(pl.partition.num_tiles for pl in plans2)
    t_b = (max(pl.partition_bwd.num_tiles for pl in plans2)
           if with_backward else 0)
    out = []
    for pl in plans2:
        pf, pb = pl.partition, pl.partition_bwd
        if pf.num_tiles < t_f or (pb is not None and pb.num_tiles < t_b):
            pl = dataclasses.replace(
                pl, partition=pad_partition_tiles(pf, t_f),
                partition_bwd=(None if pb is None
                               else pad_partition_tiles(pb, t_b)))
        out.append(pl)
    return PlanShards(parent=parent2, spec=spec2, plans=out, halo=halo2,
                      edge_ranges=edge_ranges)
