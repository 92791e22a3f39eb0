"""Incremental plan maintenance: patch a `GroupPartition` pair after a
`GraphDelta` instead of re-running the full partitioner.

The group partitioner (`core.partition.partition_graph`) has one property
this module exploits: **a tile's contents depend only on the edges of the
rows inside its node block**.  Groups are runs of one row's neighbor list,
tiles pack groups that share ``(node_block, window)``, and the global
(block, window) sort never mixes rows across blocks.  So after a delta
whose dirty destination rows touch blocks ``D``:

  * every tile with ``tile_node_block not in D`` is reused VERBATIM —
    neighbor ids are stable (deltas never renumber), padded slots still
    point at their window base, local row offsets are unchanged;
  * the dirty blocks' rows are repartitioned as a standalone square
    sub-graph (same knobs) and the two tile sets are merged with a stable
    ``(block, window)`` sort — restoring the kernel's invariant that each
    output block's tiles are consecutive (the first-visit zeroing /
    leader-flush scheme of `kernels.ops`: one run per node block);
  * ``edge_slot``/``edge_pos`` for the new graph's edges are assembled from
    the two tile maps, and the merged ``edge_val`` tensor is rebuilt by one
    O(E) scatter — so *value* changes (e.g. GCN's degree normalization,
    which a single inserted edge perturbs on structurally clean rows) never
    dirty structure.

The backward (transposed) schedule is patched the same way with dirtiness
measured on SOURCE endpoints, using a synthetic transposed-edge enumeration
``[kept old transposed edges, repartitioned sub edges]``.  Only the
*composition* of (edge_perm, edge_slot, edge_pos) is observable — the
kernel gathers ``edge_values[edge_perm]`` and scatters through the slot
maps — so the enumeration is free as long as every forward edge appears
exactly once (checked).

`Plan.apply_delta` drives both and falls back to a full repartition at the
same config above a dirty-block-fraction threshold.

Port of `src/repro/core/incremental.py` (numpy only, carried over
verbatim; the patched schedules are bit-equal to the reference's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.partition import GroupPartition, partition_graph
from repro_torch.graphs.csr import CSRGraph

__all__ = ["bwd_dirty_sources", "dirty_block_fraction", "patch_partition",
           "patch_partition_bwd"]


def dirty_block_fraction(dirty_rows: np.ndarray, num_nodes: int,
                         ont: int) -> float:
    """Fraction of output node blocks the dirty rows touch — the quantity
    `Plan.apply_delta` thresholds its fallback on."""
    nb = max(-(-num_nodes // ont), 1)
    if len(dirty_rows) == 0:
        return 0.0
    return len(np.unique(np.asarray(dirty_rows, np.int64) // ont)) / nb


def bwd_dirty_sources(g_old: CSRGraph, g2: CSRGraph,
                      edge_origin: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """``(old_to_new, dirty_src)``: the old→new forward-edge index map
    (-1 = deleted) and the unique SOURCE endpoints whose transposed
    neighbor lists changed (srcs of inserted or deleted edges)."""
    old_to_new = np.full(g_old.num_edges, -1, np.int64)
    m = edge_origin >= 0
    old_to_new[edge_origin[m]] = np.flatnonzero(m)
    deleted_src = g_old.indices[old_to_new < 0].astype(np.int64)
    inserted_src = g2.indices[~m].astype(np.int64)
    return old_to_new, np.unique(np.concatenate([deleted_src, inserted_src]))


def _square_sub(n: int, rows: np.ndarray, cols: np.ndarray) -> CSRGraph:
    """Square-over-n CSR holding only the given edges (rows ascending)."""
    counts = np.bincount(rows, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(counts)
    return CSRGraph(indptr, cols.astype(np.int32))


def _merge_tiles(p_old: GroupPartition, kept_idx: np.ndarray,
                 p_sub: GroupPartition, dirty_blocks: np.ndarray,
                 carry_vals: bool = False):
    """Merge kept old tiles with the repartitioned sub tiles by
    (node_block, window).  Returns ``(arrays, map_keep, map_sub)`` where
    the maps send a kept-old / sub tile index to its merged tile id.

    A block's tiles come from exactly one source (every sub tile sits in a
    dirty block, every kept tile in a clean one) and both inputs are
    already (block, window)-sorted, so the merge is a pure interleave of
    contiguous tile runs — slice concatenation, no global sort.  The tile
    tensors carry ~10x edge-count padding on skewed graphs, so staying at
    memcpy speed here is most of `patch_partition`'s win over a rebuild.

    With ``carry_vals`` the merged ``edge_val`` tensor is assembled the
    same way — valid only when kept tiles' values are unchanged (the
    all-ones convention both partitions share when built without values).
    """
    nb = len(dirty_blocks)
    grid = np.arange(nb + 1)
    ptr_old = np.searchsorted(p_old.tile_node_block, grid)
    ptr_sub = np.searchsorted(p_sub.tile_node_block, grid)
    starts = np.flatnonzero(np.r_[True, dirty_blocks[1:] != dirty_blocks[:-1]])
    bounds = np.r_[starts, nb]
    runs = [(dirty_blocks[b0], b0, b1)
            for b0, b1 in zip(bounds[:-1], bounds[1:])]

    def cat(a_old, a_sub):
        parts = [(a_sub[ptr_sub[b0]:ptr_sub[b1]] if d
                  else a_old[ptr_old[b0]:ptr_old[b1]]) for d, b0, b1 in runs]
        return np.concatenate(parts) if parts else a_old[:0]

    arrays = {
        "nbrs": cat(p_old.nbrs, p_sub.nbrs),
        "local_node": cat(p_old.local_node, p_sub.local_node),
        "tile_node_block": cat(p_old.tile_node_block,
                               p_sub.tile_node_block).astype(np.int32),
        "tile_window": cat(p_old.tile_window,
                           p_sub.tile_window).astype(np.int32),
    }
    if carry_vals:
        arrays["edge_val"] = cat(p_old.edge_val, p_sub.edge_val)
    # merged tile ids: disjoint block sets make the interleave rank exact
    bk = p_old.tile_node_block[kept_idx].astype(np.int64)
    bs = p_sub.tile_node_block.astype(np.int64)
    map_keep = np.arange(len(bk), dtype=np.int64) + np.searchsorted(bs, bk)
    map_sub = np.arange(len(bs), dtype=np.int64) + np.searchsorted(bk, bs)
    return arrays, map_keep, map_sub


def _scatter_vals(num_tiles: int, gpt: int, gs: int, edge_slot: np.ndarray,
                  edge_pos: np.ndarray,
                  vals: Optional[np.ndarray]) -> np.ndarray:
    """Rebuild a (T, gpt, gs) edge-value tensor from per-edge values (1.0
    default) — padding slots stay 0, the partitioner's own convention."""
    flat = np.zeros((num_tiles * gpt, gs), np.float32)
    flat[edge_slot, edge_pos] = (1.0 if vals is None
                                 else np.asarray(vals, np.float32))
    return flat.reshape(num_tiles, gpt, gs)


def patch_partition(p_old: GroupPartition, g2: CSRGraph,
                    dirty_rows: np.ndarray, edge_origin: np.ndarray,
                    edge_vals2: Optional[np.ndarray] = None
                    ) -> GroupPartition:
    """Forward-schedule patch: repartition only the node blocks touched by
    ``dirty_rows``; every other tile of ``p_old`` is reused verbatim.
    ``edge_origin`` is `DeltaResult.edge_origin`; ``edge_vals2`` is the
    new graph's full (E2,) value array (None = all ones)."""
    gs, gpt, ont, src_win = p_old.gs, p_old.gpt, p_old.ont, p_old.src_win
    n2, e2 = g2.num_nodes, g2.num_edges
    if e2 == 0:
        return partition_graph(g2, gs=gs, gpt=gpt, ont=ont, src_win=src_win)

    nb2 = -(-n2 // ont)
    dirty_blocks = np.zeros(nb2, dtype=bool)
    if len(dirty_rows):
        dirty_blocks[np.asarray(dirty_rows, np.int64) // ont] = True
    kept_idx = np.flatnonzero(~dirty_blocks[p_old.tile_node_block])

    row2_e = np.repeat(np.arange(n2, dtype=np.int64), g2.degrees)
    m_dirty = dirty_blocks[row2_e // ont]
    idx_dirty = np.flatnonzero(m_dirty)       # row-major = sub CSR edge order
    p_sub = partition_graph(
        _square_sub(n2, row2_e[idx_dirty], g2.indices[idx_dirty]),
        gs=gs, gpt=gpt, ont=ont, src_win=src_win)

    arrays, map_keep, map_sub = _merge_tiles(p_old, kept_idx, p_sub,
                                             dirty_blocks,
                                             carry_vals=edge_vals2 is None)
    num_tiles = len(arrays["tile_node_block"])

    edge_slot2 = np.empty(e2, np.int64)
    edge_pos2 = np.empty(e2, np.int32)
    clean_idx = np.flatnonzero(~m_dirty)
    if len(clean_idx):
        k = edge_origin[clean_idx]            # clean-block edges all survive
        if k.min() < 0:
            raise AssertionError("inserted edge landed in a clean block")
        old2new_tile = np.full(p_old.num_tiles, -1, np.int64)
        old2new_tile[kept_idx] = map_keep
        s_old = p_old.edge_slot[k]
        edge_slot2[clean_idx] = old2new_tile[s_old // gpt] * gpt + s_old % gpt
        edge_pos2[clean_idx] = p_old.edge_pos[k]
    if len(idx_dirty):
        s_sub = p_sub.edge_slot
        edge_slot2[idx_dirty] = map_sub[s_sub // gpt] * gpt + s_sub % gpt
        edge_pos2[idx_dirty] = p_sub.edge_pos

    if "edge_val" not in arrays:   # value change: full O(E) scatter
        arrays["edge_val"] = _scatter_vals(num_tiles, gpt, gs, edge_slot2,
                                           edge_pos2, edge_vals2)
    return GroupPartition(
        edge_slot=edge_slot2, edge_pos=edge_pos2,
        gs=gs, gpt=gpt, ont=ont, src_win=src_win,
        num_nodes=n2, num_edges=e2, **arrays)


def patch_partition_bwd(p_old: GroupPartition, edge_perm_old: np.ndarray,
                        g_old: CSRGraph, g2: CSRGraph,
                        old_to_new: np.ndarray, dirty_src: np.ndarray,
                        edge_vals2: Optional[np.ndarray] = None
                        ) -> tuple[GroupPartition, np.ndarray]:
    """Backward (transposed-graph) patch for the same delta: dirtiness is
    measured on SOURCE endpoints (``bwd_dirty_sources``).  Returns
    ``(partition_bwd, edge_perm_bwd)`` where the perm maps the new
    schedule's synthetic transposed-edge order to forward edge indices of
    ``g2`` — the only contract `kernels.ops` consumes."""
    gs, gpt, ont, src_win = p_old.gs, p_old.gpt, p_old.ont, p_old.src_win
    n2, e2 = g2.num_nodes, g2.num_edges
    if e2 == 0:
        return (partition_graph(g2, gs=gs, gpt=gpt, ont=ont,
                                src_win=src_win),
                np.zeros(0, np.int64))

    nb2 = -(-n2 // ont)
    dirty_blocks = np.zeros(nb2, dtype=bool)
    if len(dirty_src):
        dirty_blocks[np.asarray(dirty_src, np.int64) // ont] = True
    kept_idx = np.flatnonzero(~dirty_blocks[p_old.tile_node_block])

    # old transposed edge i is forward edge edge_perm_old[i]; its transposed
    # row is that edge's source.  Clean-source-block transposed edges all
    # survive (a deleted edge's source is dirty by construction).
    src_old_t = g_old.indices[edge_perm_old].astype(np.int64)
    kept_t = np.flatnonzero(~dirty_blocks[src_old_t // ont])
    fwd_of_kept = old_to_new[edge_perm_old[kept_t]]
    if len(fwd_of_kept) and fwd_of_kept.min() < 0:
        raise AssertionError("deleted edge survived in a clean source block")

    # repartition the dirty source blocks' transposed adjacency
    src2_e = g2.indices.astype(np.int64)
    m2 = dirty_blocks[src2_e // ont]
    fwd_idx = np.flatnonzero(m2)
    row_t = src2_e[fwd_idx]                          # transposed row = src
    col_t = np.repeat(np.arange(n2, dtype=np.int64), g2.degrees)[fwd_idx]
    # (src, dst) sorted: ``col_t`` ascends, so a stable sort on ``row_t``
    order_t = np.argsort(row_t, kind="stable")
    p_sub = partition_graph(
        _square_sub(n2, row_t[order_t], col_t[order_t]),
        gs=gs, gpt=gpt, ont=ont, src_win=src_win)

    arrays, map_keep, map_sub = _merge_tiles(p_old, kept_idx, p_sub,
                                             dirty_blocks,
                                             carry_vals=edge_vals2 is None)
    num_tiles = len(arrays["tile_node_block"])

    # synthetic transposed order: kept old edges (old order), then sub edges
    if len(kept_t) + len(fwd_idx) != e2:
        raise AssertionError("transposed patch does not cover every edge")
    s_keep = p_old.edge_slot[kept_t]
    old2new_tile = np.full(p_old.num_tiles, -1, np.int64)
    old2new_tile[kept_idx] = map_keep
    s_sub = p_sub.edge_slot
    edge_slot2 = np.concatenate([
        old2new_tile[s_keep // gpt] * gpt + s_keep % gpt,
        map_sub[s_sub // gpt] * gpt + s_sub % gpt])
    edge_pos2 = np.concatenate([p_old.edge_pos[kept_t], p_sub.edge_pos])
    edge_perm2 = np.concatenate([fwd_of_kept, fwd_idx[order_t]])
    # cheap exactly-once check (sum of 0..e2-1) — catches coverage bugs
    if int(edge_perm2.sum()) != e2 * (e2 - 1) // 2:
        raise AssertionError("transposed patch repeats or drops an edge")

    if "edge_val" not in arrays:   # value change: full O(E) scatter
        ev_t = np.asarray(edge_vals2, np.float32)[edge_perm2]
        arrays["edge_val"] = _scatter_vals(num_tiles, gpt, gs, edge_slot2,
                                           edge_pos2, ev_t)
    part = GroupPartition(
        edge_slot=edge_slot2, edge_pos=edge_pos2.astype(np.int32),
        gs=gs, gpt=gpt, ont=ont, src_win=src_win,
        num_nodes=n2, num_edges=e2, **arrays)
    return part, edge_perm2
