"""Community-aware node renumbering (paper §6.1).

Port of `src/repro/core/reorder.py` (carried over verbatim).

Three steps, exactly as the paper prescribes:
  1. detect communities (we use lightweight label propagation — the paper
     cites Rabbit-order-style modularity clustering; label propagation is the
     standard cheap approximation and preserves the property the runtime
     needs: intra-community nodes receive consecutive IDs);
  2. traverse nodes inside each community with Reverse Cuthill–McKee to
     maximize neighbor sharing among consecutive IDs;
  3. emit the one-to-one old→new mapping.

The payoff is concrete and measurable: consecutive IDs concentrate a node
block's neighbors into few aligned feature windows, so the group
partitioner (`core.partition`) emits fewer tiles and the kernels read
fewer feature windows (the Fig. 12b DRAM-read-reduction analogue).
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import reverse_cuthill_mckee

from repro_torch.graphs.csr import CSRGraph

__all__ = ["community_labels", "rcm_order", "renumber", "apply_renumbering"]


def community_labels(g: CSRGraph, *, rounds: int = 8, seed: int = 0) -> np.ndarray:
    """Label-propagation communities (compacted labels in [0, C)).

    Fully vectorized semi-synchronous propagation: each round counts every
    node's neighbor labels with one sort + run-length pass and updates a
    seeded random half of the nodes to their plurality label (ties broken
    toward the smallest label id, keeping the current label when it is
    among the maxima).  Updating only half the nodes per round breaks the
    two-coloring oscillation synchronous LPA is prone to while keeping the
    whole round O(E log E) — the per-node Python loop this replaces was
    unusable at full-size Type III scale (reddit: 11.6M edges), which the
    neighbor-sampling pipeline now trains on.
    """
    n = g.num_nodes
    labels = np.arange(n, dtype=np.int64)
    if n == 0 or g.num_edges == 0:
        return labels
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), g.degrees)
    cols = g.indices.astype(np.int64)
    for r in range(rounds):
        # (node, neighbor label) pairs in order, sorted as one packed key
        pair = rows * n + labels[cols]
        pair.sort()
        r_s = pair // n
        l_s = pair - r_s * n
        run = np.ones(len(r_s), dtype=bool)
        run[1:] = (r_s[1:] != r_s[:-1]) | (l_s[1:] != l_s[:-1])
        run_row = r_s[run]                      # (R,) per-run node id
        run_label = l_s[run]                    # (R,) per-run label
        counts = np.diff(np.append(np.flatnonzero(run), len(r_s)))
        # plurality with stability: +0.5 keeps the current label when tied
        score = counts.astype(np.float64)
        score[run_label == labels[run_row]] += 0.5
        # per-node argmax(score), ties -> smallest label: runs ascend by
        # (node, label), so each node's first run at its top score
        node_start = np.flatnonzero(np.r_[True, run_row[1:] != run_row[:-1]])
        upd_nodes = run_row[node_start]
        top = np.maximum.reduceat(score, node_start)
        at_top = np.flatnonzero(score == np.repeat(
            top, np.diff(np.append(node_start, len(score)))))
        first = np.ones(len(at_top), dtype=bool)
        first[1:] = run_row[at_top[1:]] != run_row[at_top[:-1]]
        upd_labels = run_label[at_top[first]]
        # semi-synchronous: flip a random half of the nodes each round
        take = rng.random(len(upd_nodes)) < 0.5 if r < rounds - 1 else \
            np.ones(len(upd_nodes), dtype=bool)
        new_labels = labels.copy()
        new_labels[upd_nodes[take]] = upd_labels[take]
        changed = int((new_labels != labels).sum())
        labels = new_labels
        if changed <= n // 200:
            break
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def rcm_order(g: CSRGraph) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the whole graph (returns node order)."""
    n = g.num_nodes
    mat = csr_matrix(
        (np.ones(g.num_edges, dtype=np.int8), g.indices, g.indptr), shape=(n, n)
    )
    return np.asarray(reverse_cuthill_mckee(mat, symmetric_mode=False), dtype=np.int64)


def renumber(g: CSRGraph, *, rounds: int = 8, seed: int = 0,
             use_communities: bool = True) -> np.ndarray:
    """Return perm with perm[old_id] = new_id (paper §6.1 steps 1–3)."""
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if use_communities:
        labels = community_labels(g, rounds=rounds, seed=seed)
    else:
        labels = np.zeros(n, dtype=np.int64)
    # order communities by size (large first) for stable packing
    comm_ids, sizes = np.unique(labels, return_counts=True)
    comm_rank = np.empty_like(comm_ids)
    comm_rank[np.argsort(-sizes, kind="stable")] = np.arange(len(comm_ids))
    rank = comm_rank[labels]

    perm = np.empty(n, dtype=np.int64)
    next_id = 0
    for r in np.argsort(np.unique(rank)):
        members = np.flatnonzero(rank == r)
        if len(members) > 2:
            sub = _induced(g, members)
            local_order = rcm_order(sub)
            members = members[local_order]
        perm[members] = np.arange(next_id, next_id + len(members))
        next_id += len(members)
    assert next_id == n
    return perm


def _induced(g: CSRGraph, members: np.ndarray) -> CSRGraph:
    """Induced subgraph on `members` with local ids 0..len-1 (vectorized;
    `induced_subgraph` keeps rows in the given member order)."""
    from repro_torch.graphs.subgraph import induced_subgraph
    return induced_subgraph(g, members)[0]


def apply_renumbering(g: CSRGraph, perm: np.ndarray,
                      feat: np.ndarray | None = None):
    """Apply perm to the graph (and optionally reorder the feature rows)."""
    g2 = g.permute(perm)
    if feat is None:
        return g2
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return g2, feat[inv]
