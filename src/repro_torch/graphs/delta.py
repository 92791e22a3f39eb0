"""Graph deltas: batched edge/node mutations against an immutable CSR.

Port of `src/repro/graphs/delta.py` (numpy only, carried over verbatim).

Production graphs mutate continuously (new users, new interactions) while
every structure downstream of `CSRGraph` — group partitions, plans, shard
splits, caches — is built from an immutable snapshot.  A `GraphDelta` is the
unit of mutation: a batch of edge insertions, optional edge/node deletions,
and optionally new nodes (appended at the end of the id space).  Applying it
produces a NEW `CSRGraph` (snapshots stay immutable; every downstream layer
swaps references at an epoch boundary — docs/dynamic.md) plus the exact
book-keeping incremental plan maintenance needs:

  * ``dirty_rows`` — destination rows whose neighbor lists changed.  Group
    partition tiles depend only on the edges of the rows inside their node
    block, so `Plan.apply_delta` repartitions ONLY the blocks these rows
    touch and keeps every other tile verbatim.
  * ``edge_origin`` — for every edge of the new CSR, the ORIGINAL edge index
    it came from (-1 for inserted edges).  This is what lets per-edge
    arrays (values, slot maps, backward permutations) be carried through a
    mutation without re-deriving them from scratch.

Deletion semantics: ``del_src/del_dst`` removes every matching copy of the
named edges; ``del_nodes`` removes all edges incident to the named nodes in
either direction (the node id itself survives, isolated — CSR ids are
positional and downstream consumers hold features by id).  Insertion of an
edge that already exists is a no-op when ``dedup`` (the default), matching
`from_edges`'s multigraph policy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graphs.csr import CSRGraph

__all__ = ["GraphDelta", "DeltaResult", "apply_delta", "carry_edge_values",
           "extend_node_features"]


def _as_ids(x, name: str) -> np.ndarray:
    a = np.asarray([] if x is None else x, dtype=np.int64).ravel()
    if a.size and a.min() < 0:
        raise ValueError(f"{name} contains negative node ids")
    return a


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of graph mutations (aggregation direction: dst gathers src).

    num_new_nodes: nodes appended at the end of the id space (ids
      ``[N, N + num_new_nodes)``); they may be referenced by the edge lists.
    add_src / add_dst: inserted edges (dst rows gather src columns).
    add_val: optional per-inserted-edge values (defaults to 1.0), aligned
      with add_src/add_dst.
    del_src / del_dst: edges to remove (all matching copies).
    del_nodes: nodes whose incident edges (both directions) are removed.
    node_feat: optional (num_new_nodes, D) features for the new nodes —
      consumers that hold a feature matrix (loader, serving engine) append
      these rows at swap time.
    dedup: inserting an already-present edge is a no-op (default).
    """

    num_new_nodes: int = 0
    add_src: Optional[np.ndarray] = None
    add_dst: Optional[np.ndarray] = None
    add_val: Optional[np.ndarray] = None
    del_src: Optional[np.ndarray] = None
    del_dst: Optional[np.ndarray] = None
    del_nodes: Optional[np.ndarray] = None
    node_feat: Optional[np.ndarray] = None
    dedup: bool = True

    def __post_init__(self):
        if self.num_new_nodes < 0:
            raise ValueError("num_new_nodes must be >= 0")
        a_src, a_dst = _as_ids(self.add_src, "add_src"), _as_ids(self.add_dst,
                                                                 "add_dst")
        if len(a_src) != len(a_dst):
            raise ValueError("add_src/add_dst length mismatch")
        if self.add_val is not None and len(np.ravel(self.add_val)) != len(a_src):
            raise ValueError("add_val length mismatch")
        d_src, d_dst = _as_ids(self.del_src, "del_src"), _as_ids(self.del_dst,
                                                                 "del_dst")
        if len(d_src) != len(d_dst):
            raise ValueError("del_src/del_dst length mismatch")
        if self.node_feat is not None and \
                len(self.node_feat) != self.num_new_nodes:
            raise ValueError("node_feat must have num_new_nodes rows")

    @property
    def num_insertions(self) -> int:
        return 0 if self.add_src is None else len(np.ravel(self.add_src))

    def is_empty(self) -> bool:
        return (self.num_new_nodes == 0 and self.num_insertions == 0
                and _as_ids(self.del_src, "del_src").size == 0
                and _as_ids(self.del_nodes, "del_nodes").size == 0)


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    """`apply_delta` output: the new snapshot + incremental book-keeping.

    graph:        the new CSR (old snapshot untouched).
    dirty_rows:   sorted unique destination rows whose edge lists changed.
    edge_origin:  (E2,) int64 — per new-CSR edge, the original edge index it
                  carries over from (-1 for inserted edges).
    inserted_val: (E2,) float32 — inserted edges' values (1.0 default) at
                  their final positions, 0 elsewhere; feed to
                  `carry_edge_values` to rebuild a per-edge value array.
    """

    graph: CSRGraph
    dirty_rows: np.ndarray
    edge_origin: np.ndarray
    inserted_val: np.ndarray


def carry_edge_values(res: DeltaResult,
                      old_vals: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Per-edge values for the new graph: surviving edges keep their old
    value (1.0 when ``old_vals`` is None), inserted edges take the delta's
    ``add_val`` (default 1.0)."""
    if old_vals is None:
        return None
    ev2 = res.inserted_val.copy()
    m = res.edge_origin >= 0
    ev2[m] = np.asarray(old_vals, np.float32)[res.edge_origin[m]]
    return ev2


def extend_node_features(feat: np.ndarray, delta: GraphDelta,
                         num_nodes: int) -> np.ndarray:
    """``feat`` (N, D) grown to ``num_nodes`` rows for a delta's new nodes:
    their rows come from ``delta.node_feat`` (cut to D columns), zeros
    where it is absent or short."""
    if num_nodes <= feat.shape[0]:
        return feat
    new = np.zeros((num_nodes - feat.shape[0], feat.shape[1]), np.float32)
    if delta.node_feat is not None:
        nf = np.asarray(delta.node_feat, np.float32)
        new[:len(nf)] = nf[:, :feat.shape[1]]
    return np.concatenate([feat, new])


def apply_delta(g: CSRGraph, delta: GraphDelta) -> DeltaResult:
    """Apply ``delta`` to ``g``; O(E_dirty + |delta| + N) (clean rows are
    copied wholesale, never inspected edge by edge)."""
    n, e = g.num_nodes, g.num_edges
    n2 = n + delta.num_new_nodes

    add_src = _as_ids(delta.add_src, "add_src")
    add_dst = _as_ids(delta.add_dst, "add_dst")
    add_val = (np.ones(len(add_src), np.float32) if delta.add_val is None
               else np.asarray(delta.add_val, np.float32).ravel().copy())
    del_src = _as_ids(delta.del_src, "del_src")
    del_dst = _as_ids(delta.del_dst, "del_dst")
    del_nodes = _as_ids(delta.del_nodes, "del_nodes")
    for name, ids in [("add_src", add_src), ("add_dst", add_dst),
                      ("del_src", del_src), ("del_dst", del_dst),
                      ("del_nodes", del_nodes)]:
        if ids.size and ids.max() >= n2:
            raise ValueError(f"{name} references node >= {n2}")

    rows_e = np.repeat(np.arange(n, dtype=np.int64), g.degrees)
    cols_e = g.indices.astype(np.int64)

    # --- dirty destination rows -----------------------------------------
    dirty = np.zeros(n2, dtype=bool)
    dirty[add_dst] = True
    dirty[del_dst] = True
    keep = np.ones(e, dtype=bool)
    if del_nodes.size:
        del_mask = np.zeros(n2, dtype=bool)
        del_mask[del_nodes] = True
        dirty[del_nodes] = True                      # their own rows empty
        hit = del_mask[cols_e]                       # rows losing a src
        dirty[rows_e[hit]] = True
        keep &= ~hit & ~del_mask[rows_e]
    if del_src.size:
        # a named edge can only live in a dirty row (its dst was just
        # marked), so match against dirty-row edges only — O(E_dirty)
        cand = np.flatnonzero(dirty[rows_e] & keep)
        key_del = np.unique(del_dst * n2 + del_src)
        key_cand = rows_e[cand] * n2 + cols_e[cand]
        pos = np.searchsorted(key_del, key_cand)
        m = pos < len(key_del)
        m[m] = key_del[pos[m]] == key_cand[m]
        keep[cand[m]] = False
    # every removed edge's row is dirty by construction; clean rows survive
    # verbatim below
    clean_e = ~dirty[rows_e]

    # --- inserted edges (dedup within the batch and vs survivors) -------
    if add_src.size:
        ins_key = add_dst * n2 + add_src
        if delta.dedup:
            _, first = np.unique(ins_key, return_index=True)
            first.sort()                             # keep FIRST copy's value
        else:
            first = np.arange(len(ins_key))
        ins_src, ins_dst = add_src[first], add_dst[first]
        ins_val = add_val[first]
        if delta.dedup:
            # no-op inserts: the edge already exists and survives deletion
            surv = ~clean_e & keep
            old_keys = rows_e[surv] * n2 + cols_e[surv]
            fresh = ~np.isin(ins_dst * n2 + ins_src, old_keys)
            ins_src, ins_dst, ins_val = (ins_src[fresh], ins_dst[fresh],
                                         ins_val[fresh])
    else:
        ins_src = ins_dst = np.zeros(0, np.int64)
        ins_val = np.zeros(0, np.float32)

    # --- assemble: clean rows verbatim + dirty rows rebuilt -------------
    # No global sort: clean edges keep their within-row offsets (their rows
    # only shift by a per-row constant), dirty rows' rebuilt edge lists are
    # sorted among themselves and scattered to their rows' new extents.
    d_old = np.flatnonzero(~clean_e & keep)          # surviving dirty edges
    rows_d = np.concatenate([rows_e[d_old], ins_dst])
    cols_d = np.concatenate([cols_e[d_old], ins_src])
    orig_d = np.concatenate([d_old, np.full(len(ins_dst), -1, np.int64)])
    val_d = np.concatenate([np.zeros(len(d_old), np.float32), ins_val])
    # (row, nbr) sorted: lexsort((cols_d, rows_d))'s order, as one stable
    # sort of a packed key (the surviving edges arrive nearly in order)
    order = np.argsort(rows_d * n2 + cols_d, kind="stable")
    rows_ds, cols_ds = rows_d[order], cols_d[order]

    deg2 = np.zeros(n2, np.int64)
    deg2[:n] = g.degrees
    deg2[dirty] = 0
    deg2 += np.bincount(rows_ds, minlength=n2).astype(np.int64)
    indptr2 = np.zeros(n2 + 1, dtype=np.int64)
    indptr2[1:] = np.cumsum(deg2)
    e2 = int(indptr2[-1])

    cols2 = np.empty(e2, np.int32)
    orig2 = np.empty(e2, np.int64)
    val2 = np.zeros(e2, np.float32)
    c_idx = np.flatnonzero(clean_e)
    if len(c_idx):
        shift = indptr2[:n] - g.indptr[:n].astype(np.int64)
        out_c = c_idx + shift[rows_e[c_idx]]
        cols2[out_c] = g.indices[c_idx]
        orig2[out_c] = c_idx
    if len(rows_ds):
        # rank within row = position minus the row's first occurrence
        pos = np.arange(len(rows_ds))
        first = np.where(np.r_[True, rows_ds[1:] != rows_ds[:-1]], pos, 0)
        within = pos - np.maximum.accumulate(first)
        out_d = indptr2[rows_ds] + within
        cols2[out_d] = cols_ds.astype(np.int32)
        orig2[out_d] = orig_d[order]
        val2[out_d] = val_d[order]
    g2 = CSRGraph(indptr2, cols2)
    return DeltaResult(graph=g2, dirty_rows=np.flatnonzero(dirty),
                       edge_origin=orig2, inserted_val=val2)
