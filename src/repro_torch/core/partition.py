"""Group-based workload partitioning (paper §5.1).

Port of `src/repro/core/partition.py` (carried over verbatim; the
schedules are bit-equal to the reference's).

The paper splits each node's neighbor list into fixed-size *groups* (size
``gs``) so one group = one balanced work unit.  The schedule is fully
static:

  * groups are window-homogeneous: every neighbor of a group lies inside one
    aligned feature window of ``src_win`` rows (window id = nbr // src_win),
    so a tile's gathers stay inside one window of the feature matrix.
  * groups are packed into *tiles* of ``gpt`` groups (the thread-per-block
    analogue §5.3); all groups of a tile share (node_block, window).
  * tiles are sorted by (node_block, window): consecutive tiles of one node
    block form one run that a single thread block accumulates in shared
    memory and flushes once (the leader-node scheme §5.2/§6.2), and
    window-sorted order maximizes feature-window reuse.

The number of tiles T is the schedule's cost unit (feature-window traffic
scales with it, the analogue of the paper's DRAM-read metric, Fig. 12b),
and community-aware renumbering (§6.1) reduces T by concentrating
neighbors into fewer windows per node block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graphs.csr import CSRGraph

__all__ = ["GroupPartition", "pad_partition_tiles", "partition_graph",
           "partition_stats", "transpose_graph"]


@dataclasses.dataclass(frozen=True)
class GroupPartition:
    """Static group schedule for the group_aggregate kernel.

    Shapes (T = num tiles, G_pad = T * gpt):
      nbrs:       (T, gpt, gs) int32 — neighbor ids (global; padded entries
                  point at the tile's window base so the in-kernel local id
                  is always in range — their edge value is 0).
      edge_val:   (T, gpt, gs) float32 — per-edge values; 0 ⇒ padding.
      local_node: (T, gpt) int32 — target row within the output node block.
      tile_node_block: (T,) int32 — output block index (scalar-prefetched).
      tile_window:     (T,) int32 — feature window index (scalar-prefetched).
    """

    nbrs: np.ndarray
    edge_val: np.ndarray
    local_node: np.ndarray
    tile_node_block: np.ndarray
    tile_window: np.ndarray
    # dynamic-edge-value support (GAT-type archs, §4.2 type 2): for original
    # CSR edge e, its group slot is (edge_slot[e] // gpt, edge_slot[e] % gpt,
    # edge_pos[e]) — lets callers scatter per-forward edge weights into the
    # schedule layout without repartitioning.
    edge_slot: np.ndarray      # (E,) int64 flat group index per ORIGINAL edge
    edge_pos: np.ndarray       # (E,) int32 slot within the group
    # static config
    gs: int
    gpt: int
    ont: int
    src_win: int
    num_nodes: int
    num_edges: int

    @property
    def num_tiles(self) -> int:
        return int(self.nbrs.shape[0])

    @property
    def num_groups(self) -> int:
        return int(self.nbrs.shape[0] * self.nbrs.shape[1])

    def edge_values_csr(self) -> Optional[np.ndarray]:
        """Recover per-edge values in ORIGINAL CSR edge order — the
        inverse of the slot scatter (edge e lives at flat group
        ``edge_slot[e]``, position ``edge_pos[e]``).  Returns None for an
        edge-less partition.  This is how the shard splitter and the
        sharded sampled trainer re-plan a graph under different knobs
        without the caller having kept the value array around."""
        if self.num_edges == 0:
            return None
        return self.edge_val.reshape(-1, self.gs)[self.edge_slot,
                                                  self.edge_pos]

    @property
    def padded_src_rows(self) -> int:
        """Feature rows needed (multiple of src_win covering all of N)."""
        return int(-(-self.num_nodes // self.src_win) * self.src_win)

    @property
    def padded_out_rows(self) -> int:
        return int(-(-self.num_nodes // self.ont) * self.ont)

    def block_visited(self, num_blocks: Optional[int] = None) -> np.ndarray:
        """(num_blocks,) bool — output node blocks named by >= 1 tile.

        The kernel zeroes an output block only on its first VISIT, so
        blocks no tile names (bipartite sampled blocks' edge-less rows)
        must be masked to zero by the caller.  This mask is schedule-static
        — `DeviceSchedule` uploads it once instead of rebuilding it from
        ``tile_node_block`` on every call.  ``num_blocks``
        overrides the length for callers that widen the output geometry
        (the sharded sampled trainer's node-bucket uniformization).
        """
        if num_blocks is None:
            num_blocks = self.padded_out_rows // self.ont
        v = np.zeros(num_blocks, dtype=bool)
        v[self.tile_node_block] = True
        return v


def _sort_rows_by_neighbor(g: CSRGraph, edge_vals: Optional[np.ndarray]):
    """Sort each CSR row's neighbors ascending, permuting edge values along."""
    indices = g.indices.copy()
    vals = None if edge_vals is None else np.asarray(edge_vals, dtype=np.float32).copy()
    indptr = g.indptr
    # Row-wise sort via a global stable sort on (row, nbr).
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees)
    order = np.lexsort((indices, rows))
    indices = indices[order]
    if vals is not None:
        vals = vals[order]
    return rows, indices, vals, order, indptr


def partition_graph(g: CSRGraph, *, gs: int = 16, gpt: int = 16, ont: int = 8,
                    src_win: int = 512,
                    edge_vals: Optional[np.ndarray] = None) -> GroupPartition:
    """Build the static group schedule for graph ``g``.

    edge_vals: optional (E,) per-edge weights aligned with g.indices
      (e.g. GCN 1/sqrt(d_u d_v) normalization, or GIN's (1+eps) self loops).
      Defaults to 1.0 for every edge.
    """
    if gs <= 0 or gpt <= 0 or ont <= 0 or src_win <= 0:
        raise ValueError("gs, gpt, ont, src_win must all be positive")
    n, e = g.num_nodes, g.num_edges
    if e == 0:
        z3 = np.zeros((0, gpt, gs), np.int32)
        z1 = np.zeros((0,), np.int64)
        return GroupPartition(z3, z3.astype(np.float32), np.zeros((0, gpt), np.int32),
                              np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                              z1, z1.astype(np.int32),
                              gs=gs, gpt=gpt, ont=ont, src_win=src_win,
                              num_nodes=n, num_edges=0)

    rows, nbrs_e, vals_e, sort_order, _ = _sort_rows_by_neighbor(g, edge_vals)
    if vals_e is None:
        vals_e = np.ones(e, dtype=np.float32)
    win_e = nbrs_e.astype(np.int64) // src_win

    # --- group formation: runs of equal (row, window), chunked by gs ---
    change = np.ones(e, dtype=bool)
    change[1:] = (rows[1:] != rows[:-1]) | (win_e[1:] != win_e[:-1])
    run_id = np.cumsum(change) - 1
    run_start = np.flatnonzero(change)
    pos_in_run = np.arange(e) - run_start[run_id]
    chunk = pos_in_run // gs
    new_group = change | ((pos_in_run % gs) == 0)
    group_id = np.cumsum(new_group) - 1          # per-edge group index
    num_groups = int(group_id[-1]) + 1
    pos_in_group = pos_in_run % gs

    g_start = np.flatnonzero(new_group)
    grp_node = rows[g_start]                      # (G,)
    grp_win = win_e[g_start]                      # (G,)
    grp_block = grp_node // ont                   # (G,)

    # --- bucket by (node_block, window); groups arrive sorted by (node, win)
    # so a stable sort on (block, window) keeps nodes ordered inside buckets.
    bucket_key = grp_block * (win_e.max() + 1) + grp_win
    order = np.argsort(bucket_key, kind="stable")
    # bucket boundaries over the sorted groups
    sk = bucket_key[order]
    bchange = np.ones(num_groups, dtype=bool)
    bchange[1:] = sk[1:] != sk[:-1]
    bucket_id = np.cumsum(bchange) - 1
    bstart = np.flatnonzero(bchange)
    bsizes = np.diff(np.append(bstart, num_groups))
    bpad = -(-bsizes // gpt) * gpt                # per-bucket padded size
    bpad_start = np.concatenate([[0], np.cumsum(bpad)])
    g_pad_total = int(bpad_start[-1])
    T = g_pad_total // gpt

    # padded slot of each (sorted) group
    pos_in_bucket = np.arange(num_groups) - bstart[bucket_id]
    slot_sorted = bpad_start[bucket_id] + pos_in_bucket     # (G,) sorted order
    slot = np.empty(num_groups, dtype=np.int64)
    slot[order] = slot_sorted

    # --- tile metadata ---
    tile_of_bucket_w = np.zeros(T, dtype=np.int32)
    tile_of_bucket_b = np.zeros(T, dtype=np.int32)
    bucket_w = grp_win[order][bstart]
    bucket_b = grp_block[order][bstart]
    for bi in range(len(bstart)):                 # few buckets; loop is fine
        t0, t1 = bpad_start[bi] // gpt, bpad_start[bi + 1] // gpt
        tile_of_bucket_w[t0:t1] = bucket_w[bi]
        tile_of_bucket_b[t0:t1] = bucket_b[bi]

    # --- fill flat group arrays ---
    nbrs = np.empty((g_pad_total, gs), dtype=np.int32)
    # padded neighbor ids point at their tile's window base (always in range)
    nbrs[:] = (np.repeat(tile_of_bucket_w, gpt)[:, None] * src_win).astype(np.int32)
    eval_ = np.zeros((g_pad_total, gs), dtype=np.float32)
    lnode = np.zeros(g_pad_total, dtype=np.int32)
    lnode_groups = (grp_node - grp_block * ont).astype(np.int32)
    lnode[slot] = lnode_groups
    nbrs[slot[group_id], pos_in_group] = nbrs_e.astype(np.int32)
    eval_[slot[group_id], pos_in_group] = vals_e

    # original-edge -> (slot, pos) mapping: sorted edge i is original edge
    # sort_order[i]
    edge_slot = np.empty(e, dtype=np.int64)
    edge_pos = np.empty(e, dtype=np.int32)
    edge_slot[sort_order] = slot[group_id]
    edge_pos[sort_order] = pos_in_group.astype(np.int32)

    return GroupPartition(
        nbrs=nbrs.reshape(T, gpt, gs),
        edge_val=eval_.reshape(T, gpt, gs),
        local_node=lnode.reshape(T, gpt),
        tile_node_block=tile_of_bucket_b,
        tile_window=tile_of_bucket_w,
        edge_slot=edge_slot, edge_pos=edge_pos,
        gs=gs, gpt=gpt, ont=ont, src_win=src_win,
        num_nodes=n, num_edges=e,
    )


def pad_partition_tiles(p: GroupPartition, target_tiles: int) -> GroupPartition:
    """Append no-op tiles (zero edge values, last tile's block/window) until
    ``num_tiles == target_tiles``.  edge_slot/edge_pos stay valid: original
    flat group slots are unchanged, new slots only appended.  This is how
    shape bucketing works everywhere schedules must share one compiled
    executable — the serving plan cache's pow2 buckets and the shard
    splitter's uniform per-shard tile counts (shard_map operands must have
    identical shapes on every device)."""
    T = p.num_tiles
    if target_tiles <= T:
        return p
    pad = target_tiles - T
    # an empty partition has no "last tile" to clone — window/block 0 tiles
    # with zero edge values are equally inert
    win = int(p.tile_window[-1]) if T > 0 else 0
    blk = int(p.tile_node_block[-1]) if T > 0 else 0
    return dataclasses.replace(
        p,
        nbrs=np.concatenate(
            [p.nbrs, np.full((pad, p.gpt, p.gs), win * p.src_win, np.int32)]),
        edge_val=np.concatenate(
            [p.edge_val, np.zeros((pad, p.gpt, p.gs), np.float32)]),
        local_node=np.concatenate(
            [p.local_node, np.zeros((pad, p.gpt), np.int32)]),
        tile_node_block=np.concatenate(
            [p.tile_node_block, np.full(pad, blk, np.int32)]),
        tile_window=np.concatenate(
            [p.tile_window, np.full(pad, win, np.int32)]),
    )


def transpose_graph(g: CSRGraph, edge_vals: Optional[np.ndarray] = None,
                    ) -> tuple[CSRGraph, Optional[np.ndarray], np.ndarray]:
    """Transpose a CSR graph, carrying per-edge values along.

    Aggregation computes ``out = A @ feat`` where ``A[dst, src] = ev`` for
    every CSR edge (row = dst, ``indices`` = src).  Its linearization w.r.t.
    ``feat`` is ``A^T @ g`` — aggregation over the TRANSPOSED graph with the
    same edge values.  This helper emits that graph so the advisor can
    pre-plan both directions (the forward/backward kernel-template pairing
    FeatGraph describes for training).

    Unlike ``from_edges`` this never dedups or symmetrizes: the edge
    *multiset* is preserved exactly, which is what linearity requires.

    Returns ``(gT, edge_vals_T, edge_perm)`` where ``edge_perm`` maps
    transposed-CSR edge index ``i`` to the ORIGINAL CSR edge index it came
    from (``gT``'s edge ``i`` is ``g``'s edge ``edge_perm[i]``), so dynamic
    per-edge values can be re-laid-out as ``ev_T = ev[edge_perm]``.
    ``edge_vals_T`` is that permutation applied to ``edge_vals`` (None in,
    None out).
    """
    n = g.num_nodes
    rows, cols = g.to_coo()                    # rows = dst, cols = src
    # transposed edge: new row = cols, new neighbor = rows; CSR wants edges
    # sorted by (new_row, new_nbr) to match partition's row-wise sorting
    # convention (and permute()'s lexsort order).
    order = np.lexsort((rows, cols))
    counts = np.bincount(cols, minlength=n).astype(np.int64)
    new_indptr = np.concatenate([[0], np.cumsum(counts)])
    gT = CSRGraph(new_indptr, rows[order].astype(np.int32))
    vals_t = None
    if edge_vals is not None:
        vals_t = np.asarray(edge_vals, dtype=np.float32)[order]
    return gT, vals_t, order.astype(np.int64)


def partition_stats(p: GroupPartition) -> dict:
    """Schedule quality metrics — the runtime's cost counters.

    ``tiles`` drives feature-window DMA traffic (locality metric, Fig. 12b
    analogue); ``occupancy`` is the fraction of group slots holding real
    edges (workload-balance metric, Fig. 9a analogue); ``flushes`` counts
    output write-backs (leader-node metric, Fig. 12c analogue).
    """
    T = p.num_tiles
    real = int((p.edge_val != 0).sum())
    slots = p.num_groups * p.gs
    nb = p.tile_node_block
    flushes = int(1 + (nb[1:] != nb[:-1]).sum()) if T > 0 else 0
    window_dmas = int(1 + ((p.tile_window[1:] != p.tile_window[:-1])
                           | (nb[1:] != nb[:-1])).sum()) if T > 0 else 0
    return {
        "tiles": T,
        "groups": p.num_groups,
        "slot_occupancy": real / max(slots, 1),
        "edges": p.num_edges,
        "flushes": flushes,
        "window_dmas": window_dmas,
        "window_bytes": window_dmas * p.src_win * 4,  # per dim-tile column of 1 elem… scaled by D at use site
    }
