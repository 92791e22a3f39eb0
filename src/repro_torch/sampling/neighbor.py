"""Layer-wise neighbor (fanout) sampling over a resident `CSRGraph`.

Port of `src/repro/sampling/neighbor.py`, numpy only and unchanged, so the
port's blocks are bit-identical to the reference's for the same ``(graph,
seeds, fanouts, seed, edge_mode)``: the tests hold whole batches equal.

GraphSAGE-style mini-batch construction: starting from a batch of seed
(output) nodes, each GNN layer samples at most ``fanout`` in-neighbors per
frontier node and emits one bipartite *message-flow block* per layer.  The
full-batch advisor pipeline then runs per block — which is exactly the
regime GNNAdvisor's machinery is built for: many small, recurring-shape
workloads whose planning cost is amortized by the serving plan cache
(`repro_torch.serving.plan_cache`) instead of one monolithic full-graph
plan that cannot fit a training step for Type III graphs.

Block contract
--------------
A `Block` is the induced sampled bipartite graph of one layer, stored as a
SQUARE CSR so the unmodified partitioner / kernels / `PlanExecutor` apply:

  * local node ids ``0..num_src-1`` enumerate the layer's SOURCE frontier;
    the first ``num_dst`` of them are the DESTINATION nodes (consecutive
    dst renumbering), so the next layer's input is simply ``out[:num_dst]``
    — no gather between layers.
  * rows ``0..num_dst-1`` hold each dst's sampled in-edges (plus its
    self-loop for GCN); rows ``num_dst..num_src-1`` are empty, so the
    aggregation output is zero there and the square embedding is exact.
  * ``src_nodes[i]`` is the global id of local node ``i``; chained blocks
    satisfy ``blocks[l].src_nodes[:blocks[l].num_dst] ==
    blocks[l+1].src_nodes`` (same order).

Unbiasedness (the estimator the tests assert)
---------------------------------------------
Full-graph GCN aggregation at node v is

    y_v = w_vv x_v + sum_u  w_vu x_u,     w_vu = 1/sqrt(d-hat_v d-hat_u)

with d-hat = in-degree + 1 (self-loops folded, `models.gnn.gcn_edge_values`,
degrees always taken from the FULL resident graph).  Sampling k_v = min(f,
d_v) of the d_v in-neighbors uniformly WITHOUT replacement includes each
edge with probability k_v/d_v, so scaling every sampled edge by d_v/k_v and
keeping the self-loop exact gives E[y-hat_v] = y_v: each block's aggregation
is an unbiased estimate of the full-graph op at its dst nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.graphs.csr import CSRGraph

__all__ = ["Block", "SampledBatch", "sample_frontier", "sample_blocks",
           "block_aggregate_ref"]


@dataclasses.dataclass(frozen=True)
class Block:
    """One layer's sampled bipartite message-flow graph (see module doc)."""

    graph: CSRGraph            # square CSR, num_nodes == num_src
    src_nodes: np.ndarray      # (num_src,) global ids; [:num_dst] are dst
    num_dst: int
    edge_vals: Optional[np.ndarray]  # (E,) float32 aligned with graph.indices

    @property
    def num_src(self) -> int:
        return int(self.graph.num_nodes)


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """All L blocks of one mini-batch, in FORWARD layer order.

    ``blocks[0]`` is the first GNN layer (widest frontier, consumes raw
    input features on ``input_nodes``); ``blocks[-1]``'s dst nodes are the
    ``seeds``.
    """

    blocks: tuple
    seeds: np.ndarray          # (B,) global ids = blocks[-1] dst
    input_nodes: np.ndarray    # blocks[0].src_nodes

    @property
    def num_layers(self) -> int:
        return len(self.blocks)


def sample_frontier(g: CSRGraph, frontier: np.ndarray, fanout: int,
                    rng: np.random.Generator,
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample <= ``fanout`` in-edges per frontier node, without replacement.

    Vectorized: every candidate edge draws a uniform key, edges are ranked
    within their row by key, and the first min(d, fanout) survive.

    Returns ``(rows_local, flat_edge_pos, scale)``: the kept edges' local
    dst row, their flat position in ``g.indices``, and the per-edge
    importance weight d/k making the sampled sum unbiased.
    """
    frontier = np.asarray(frontier, dtype=np.int64)
    starts = g.indptr[frontier]
    counts = (g.indptr[frontier + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=np.float32)
    cum = np.concatenate([[0], np.cumsum(counts)])
    rows_local = np.repeat(np.arange(len(frontier), dtype=np.int64), counts)
    flat = np.repeat(starts - cum[:-1], counts) + np.arange(total)
    if fanout <= 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=np.float32)
    key = rng.random(total)
    # a row keeps its min(d, fanout) edges of least (key, position): every
    # edge of a row at or under the fanout, else one partial sort of the
    # row's keys (equal keys taken by position) -- the edges a lexsort of
    # every candidate by (row, key) ranks first, without that sort
    keep_mask = np.ones(total, dtype=bool)
    for r in np.flatnonzero(counts > fanout):
        seg = key[cum[r]:cum[r + 1]]
        kth = np.partition(seg, fanout - 1)[fanout - 1]
        sel = seg < kth
        sel[np.flatnonzero(seg == kth)[:fanout - int(sel.sum())]] = True
        keep_mask[cum[r]:cum[r + 1]] = sel
    keep = np.flatnonzero(keep_mask)  # deterministic per-row CSR edge order
    k = np.minimum(counts, fanout).astype(np.float64)
    scale = (counts.astype(np.float64) / np.maximum(k, 1.0))[rows_local[keep]]
    return rows_local[keep], flat[keep], scale.astype(np.float32)


def _gcn_half_norm(g: CSRGraph) -> np.ndarray:
    """1/sqrt(in-degree + 1) per node — A-hat's half-normalization, from
    FULL-graph degrees (never recomputed on a subgraph)."""
    return (1.0 / np.sqrt(g.degrees.astype(np.float64) + 1.0)).astype(
        np.float64)


def sample_blocks(g: CSRGraph, seeds: Sequence[int], fanouts: Sequence[int],
                  *, seed: int = 0, rng: Optional[np.random.Generator] = None,
                  edge_mode: str = "gcn") -> SampledBatch:
    """Build the L bipartite blocks for one seed batch (L = len(fanouts)).

    fanouts[l] is the per-node fanout of GNN layer l (forward order:
    layer 0 touches raw input features).  Sampling proceeds OUTWARD from the
    seeds: layer L-1's dst = seeds, its sampled sources become layer L-2's
    dst frontier, and so on.

    edge_mode:
      * "gcn"   — self-loops added, edge value = (d_v/k_v) / sqrt(d-hat_v
                  d-hat_u) with full-graph degrees; unbiased GCN estimator.
      * "scale" — no self-loops, edge value = d_v/k_v (unbiased plain-sum
                  estimator — the GIN aggregation input).
      * "unit"  — no self-loops, edge value 1.0 (biased GraphSAGE-mean-style
                  raw sum; callers normalize themselves).
    """
    if edge_mode not in ("gcn", "scale", "unit"):
        raise ValueError(f"unknown edge_mode {edge_mode!r}")
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    if len(seeds) == 0:
        raise ValueError("sample_blocks needs at least one seed")
    if seeds[0] < 0 or seeds[-1] >= g.num_nodes:
        raise ValueError("seed ids out of range")
    if len(fanouts) == 0:
        raise ValueError("fanouts must name one fanout per GNN layer")
    rng = rng if rng is not None else np.random.default_rng(seed)
    half = _gcn_half_norm(g) if edge_mode == "gcn" else None

    blocks: list[Block] = []
    frontier = seeds              # dst set of the current (deepest) layer
    for fanout in reversed(list(fanouts)):
        rows_local, flat, scale = sample_frontier(g, frontier, int(fanout),
                                                  rng)
        cols_global = g.indices[flat].astype(np.int64)
        # source frontier = dst nodes first (consecutive renumbering), then
        # the newly-reached nodes in sorted global order (deterministic).
        in_dst = np.zeros(g.num_nodes, dtype=bool)
        in_dst[frontier] = True
        new_nodes = np.unique(cols_global[~in_dst[cols_global]])
        src_nodes = np.concatenate([frontier, new_nodes])
        local = np.empty(g.num_nodes, dtype=np.int64)  # only src slots read
        local[src_nodes] = np.arange(len(src_nodes))
        n_dst, n_src = len(frontier), len(src_nodes)

        cols_local = local[cols_global]
        if edge_mode == "gcn":
            vals = (scale.astype(np.float64)
                    * half[frontier[rows_local]] * half[cols_global])
            # self-loop edges: exact weight 1/d-hat_v, never sampled away
            sl_rows = np.arange(n_dst, dtype=np.int64)
            rows_all = np.concatenate([rows_local, sl_rows])
            cols_all = np.concatenate([cols_local, sl_rows])
            vals_all = np.concatenate([vals, half[frontier] ** 2])
        elif edge_mode == "scale":
            rows_all, cols_all, vals_all = (rows_local, cols_local,
                                            scale.astype(np.float64))
        else:
            rows_all, cols_all = rows_local, cols_local
            vals_all = np.ones(len(rows_local), dtype=np.float64)

        order = np.lexsort((cols_all, rows_all))
        rows_s, cols_s = rows_all[order], cols_all[order]
        indptr = np.zeros(n_src + 1, dtype=np.int64)
        np.add.at(indptr, rows_s + 1, 1)
        indptr = np.cumsum(indptr)
        blocks.append(Block(
            graph=CSRGraph(indptr, cols_s.astype(np.int32)),
            src_nodes=src_nodes, num_dst=n_dst,
            edge_vals=vals_all[order].astype(np.float32)))
        frontier = src_nodes
    blocks.reverse()
    return SampledBatch(blocks=tuple(blocks), seeds=seeds,
                        input_nodes=blocks[0].src_nodes)


def block_aggregate_ref(block: Block, feat: np.ndarray) -> np.ndarray:
    """Dense numpy oracle: one block's aggregation, rows 0..num_dst-1 real.

    ``feat`` is (num_src, D) in the block's local order.  Used by the
    unbiasedness tests; the runtime path goes through `PlanExecutor`.
    """
    rows, cols = block.graph.to_coo()
    out = np.zeros((block.num_src, feat.shape[1]), dtype=np.float64)
    np.add.at(out, rows,
              block.edge_vals[:, None].astype(np.float64) * feat[cols])
    return out
