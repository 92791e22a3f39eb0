"""k-hop ego-graph extraction and request batching for the serving engine.

Port of `src/repro/graphs/subgraph.py` (carried over verbatim).

Direction note: `CSRGraph` row v holds the sources v *gathers from*
(aggregation direction dst <- src), so frontier expansion along CSR rows
collects exactly the in-neighbor closure an L-layer GNN needs: the induced
subgraph on the L-hop ball contains every edge feeding any node whose
aggregate the seed's output consumes (nodes at distance d contribute their
layer-l value only for l <= L - d, and all their in-neighbors sit at
distance <= d + 1 <= L).  Per-node normalizations (GCN's 1/sqrt(d_u d_v))
must use FULL-graph degrees, which is why `edge_vals` are sliced from the
resident graph rather than recomputed on the subgraph.

Everything is vectorized host-side numpy — this is the serving hot path's
pre-kernel cost, run per micro-batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.graphs.csr import CSRGraph

__all__ = [
    "EgoGraph",
    "BatchedEgo",
    "k_hop_nodes",
    "induced_subgraph",
    "extract_ego",
    "batch_egos",
    "pad_to_nodes",
]


@dataclasses.dataclass(frozen=True)
class EgoGraph:
    """Induced subgraph around one seed set, with the global<->local maps."""

    graph: CSRGraph              # local node ids, rows in `nodes` order
    nodes: np.ndarray            # (n_sub,) global id of local node i
    seed_local: np.ndarray       # (num_seeds,) local ids of the seeds
    edge_vals: Optional[np.ndarray]  # (e_sub,) sliced from the full graph
    hops: int


@dataclasses.dataclass(frozen=True)
class BatchedEgo:
    """Disjoint union of ego-graphs: one block-diagonal batched CSR."""

    graph: CSRGraph
    nodes: np.ndarray            # (n_total,) global ids, block-concatenated
    seed_local: np.ndarray       # (num_seeds,) seed ids in the batched graph
    seed_owner: np.ndarray       # (num_seeds,) index of the source ego
    node_offsets: np.ndarray     # (B+1,) node-block boundaries
    edge_vals: Optional[np.ndarray]


def _gather_rows(g: CSRGraph, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Flat-concatenate the neighbor lists of `rows` without a Python loop.

    Returns (flat global edge positions, per-row counts): the caller indexes
    `g.indices` (and per-edge arrays) with the positions.
    """
    starts = g.indptr[rows]
    counts = g.indptr[rows + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), counts
    cum = np.concatenate([[0], np.cumsum(counts)])
    flat = np.repeat(starts - cum[:-1], counts) + np.arange(total)
    return flat, counts


def k_hop_nodes(g: CSRGraph, seeds: np.ndarray, k: int) -> np.ndarray:
    """All nodes reachable from `seeds` in <= k frontier hops (sorted).

    Seeds may repeat (deduplicated), be zero-degree (returned alone), or be
    empty (empty result); ``k == 0`` returns the seed set itself.  Node
    order is always sorted ascending — deterministic for cache keys.
    """
    frontier = np.unique(np.asarray(seeds, dtype=np.int64))
    if k < 0:
        raise ValueError(f"hops must be >= 0, got {k}")
    if len(frontier) and (frontier[0] < 0 or frontier[-1] >= g.num_nodes):
        # catch this here: a negative id would silently WRAP (visited[-1]
        # marks the last node) before any downstream IndexError fires
        raise ValueError(
            f"seed ids must be in [0, {g.num_nodes}), got "
            f"[{frontier[0]}, {frontier[-1]}]")
    visited = np.zeros(g.num_nodes, dtype=bool)
    visited[frontier] = True
    for _ in range(k):
        if len(frontier) == 0:
            break
        flat, _ = _gather_rows(g, frontier)
        nbrs = np.unique(g.indices[flat].astype(np.int64))
        frontier = nbrs[~visited[nbrs]]
        visited[frontier] = True
    return np.flatnonzero(visited)


def induced_subgraph(g: CSRGraph, nodes: np.ndarray,
                     edge_vals: Optional[np.ndarray] = None,
                     ) -> tuple[CSRGraph, Optional[np.ndarray]]:
    """Induced subgraph on sorted global `nodes`, preserving per-row edge
    order; per-edge values are sliced along when given."""
    nodes = np.asarray(nodes, dtype=np.int64)
    ns = len(nodes)
    local = np.full(g.num_nodes, -1, dtype=np.int64)
    local[nodes] = np.arange(ns)
    flat, counts = _gather_rows(g, nodes)
    nbr_local = local[g.indices[flat]]
    keep = nbr_local >= 0
    row_of = np.repeat(np.arange(ns, dtype=np.int64), counts)
    sub_counts = np.bincount(row_of[keep], minlength=ns)
    indptr = np.zeros(ns + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(sub_counts)
    sub = CSRGraph(indptr, nbr_local[keep].astype(np.int32))
    vals = None
    if edge_vals is not None:
        vals = np.asarray(edge_vals, dtype=np.float32)[flat[keep]]
    return sub, vals


def extract_ego(g: CSRGraph, seeds, hops: int,
                edge_vals: Optional[np.ndarray] = None) -> EgoGraph:
    """Multi-source k-hop ego-graph: the union ball of all `seeds`.

    Inherits `k_hop_nodes`' edge-case contract (zero-degree / duplicate /
    empty seeds, ``hops == 0``, bounds validation); duplicate seeds get
    duplicate ``seed_local`` entries (one output row per request) while the
    node set itself stays duplicate-free.
    """
    seeds = np.atleast_1d(np.asarray(seeds, dtype=np.int64))
    nodes = k_hop_nodes(g, seeds, hops)
    sub, vals = induced_subgraph(g, nodes, edge_vals)
    local = np.full(g.num_nodes, -1, dtype=np.int64)
    local[nodes] = np.arange(len(nodes))
    return EgoGraph(graph=sub, nodes=nodes, seed_local=local[seeds],
                    edge_vals=vals, hops=hops)


def batch_egos(egos: Sequence[EgoGraph]) -> BatchedEgo:
    """Disjoint-union a list of ego-graphs into one batched CSR.

    Block-diagonal: ego b's node i becomes batched node `node_offsets[b]+i`;
    no cross-ego edges exist, so per-seed outputs are bit-identical to
    running each ego alone.
    """
    assert len(egos) > 0
    n_off = np.cumsum([0] + [e.graph.num_nodes for e in egos])
    e_off = np.cumsum([0] + [e.graph.num_edges for e in egos])
    indptr = np.concatenate(
        [np.zeros(1, np.int64)]
        + [e.graph.indptr[1:] + e_off[i] for i, e in enumerate(egos)])
    indices = np.concatenate(
        [e.graph.indices.astype(np.int64) + n_off[i]
         for i, e in enumerate(egos)])
    seed_local = np.concatenate(
        [e.seed_local + n_off[i] for i, e in enumerate(egos)])
    seed_owner = np.concatenate(
        [np.full(len(e.seed_local), i, dtype=np.int64) for i, e in enumerate(egos)])
    vals = None
    if all(e.edge_vals is not None for e in egos):
        vals = np.concatenate([e.edge_vals for e in egos])
    return BatchedEgo(
        graph=CSRGraph(indptr.astype(np.int64), indices.astype(np.int32)),
        nodes=np.concatenate([e.nodes for e in egos]),
        seed_local=seed_local, seed_owner=seed_owner,
        node_offsets=n_off, edge_vals=vals)


def pad_to_nodes(g: CSRGraph, target_nodes: int) -> CSRGraph:
    """Append edge-less nodes so num_nodes == target_nodes (shape bucketing:
    padded subgraphs land on a small set of recurring operand shapes)."""
    extra = target_nodes - g.num_nodes
    if extra <= 0:
        return g
    indptr = np.concatenate(
        [g.indptr, np.full(extra, g.indptr[-1], dtype=np.int64)])
    return CSRGraph(indptr, g.indices)
