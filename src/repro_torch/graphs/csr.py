"""CSR graph structure and synthetic graph generators.

Port of `src/repro/graphs/csr.py` (numpy only, carried over verbatim;
`apply_delta` waits for the mutable-graph slice).

Everything here is host-side numpy: graph preprocessing (extraction,
partitioning, renumbering) is a one-time cost the paper performs on CPU as
well (GNNAdvisor's "input extractor" runs before kernel launch).  Device
arrays are produced only by `repro.core.partition` when the group tensors are
materialized.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CSRGraph",
    "from_edges",
    "random_power_law",
    "random_community_graph",
    "grid_graph",
]


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency.

    indptr:  (N+1,) int64 — row pointers.
    indices: (E,)   int32 — column ids (neighbor node ids).
    num_nodes / num_edges are derived but stored for clarity.
    """

    indptr: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        assert self.indptr.ndim == 1 and self.indices.ndim == 1
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def avg_degree(self) -> float:
        n = self.num_nodes
        return float(self.num_edges) / max(n, 1)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def with_self_loops(self) -> "CSRGraph":
        """Return a graph with i->i edges added (GCN-style A-hat)."""
        n = self.num_nodes
        degs = self.degrees
        new_indptr = np.zeros(n + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(degs + 1)
        new_indices = np.empty(self.num_edges + n, dtype=np.int32)
        # row v's slot block starts at indptr[v] + v: self-loop first, then
        # the old neighbors shifted right by (v + 1).
        new_indices[new_indptr[:-1]] = np.arange(n, dtype=np.int32)
        rows = np.repeat(np.arange(n, dtype=np.int64), degs)
        new_indices[np.arange(self.num_edges) + rows + 1] = self.indices
        return CSRGraph(new_indptr, new_indices)

    def _permute_edge_order(self, perm: np.ndarray):
        """``(order, new_cols)`` induced by `permute(perm)`: position i of
        the permuted graph's edge array holds this graph's edge
        ``order[i]`` (whose relabelled neighbor is ``new_cols[order[i]]``).
        The single source of truth for how edge-aligned arrays travel
        through a node relabelling (used by both `permute` and
        `permute_edge_vals` — keep them in lockstep)."""
        assert perm.shape == (self.num_nodes,)
        new_rows = np.repeat(perm, self.degrees)
        new_cols = perm[self.indices]
        return np.lexsort((new_cols, new_rows)), new_cols

    def permute(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel nodes: new id of old node v is perm[v].

        Rows are re-sorted so that row perm[v] holds the (relabelled)
        neighbors of old node v.  Neighbor lists are kept sorted by new id,
        which maximizes gather locality inside a group.
        """
        n = self.num_nodes
        order, new_cols = self._permute_edge_order(perm)
        new_degs = np.zeros(n, dtype=np.int64)
        new_degs[perm] = self.degrees
        new_indptr = np.zeros(n + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(new_degs)
        return CSRGraph(new_indptr, new_cols[order].astype(np.int32))

    def permute_edge_vals(self, perm: np.ndarray,
                          edge_vals: np.ndarray) -> np.ndarray:
        """Carry per-edge values (aligned with ``self.indices``) through
        `permute`'s exact edge order: returns the array aligned with
        ``self.permute(perm).indices``."""
        order, _ = self._permute_edge_order(perm)
        return np.asarray(edge_vals, dtype=np.float32)[order]

    def to_coo(self) -> tuple[np.ndarray, np.ndarray]:
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int32), self.degrees)
        return rows, self.indices.copy()


def from_edges(num_nodes: int, src: np.ndarray, dst: np.ndarray,
               symmetrize: bool = False, dedup: bool = True) -> CSRGraph:
    """Build CSR from an edge list src->dst (aggregation direction: dst gathers src)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if dedup:
        key = dst * num_nodes + src
        key = np.unique(key)
        dst, src = key // num_nodes, key % num_nodes
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(indptr, src.astype(np.int32))


def random_power_law(num_nodes: int, avg_degree: float, *, exponent: float = 2.1,
                     seed: int = 0, symmetrize: bool = True) -> CSRGraph:
    """Power-law degree graph via a Chung–Lu style sampler.

    Real-world graphs follow power-law degree distributions (paper §4.1.1);
    this generator reproduces that skew (the input property the group
    partitioner exploits) without shipping datasets.
    """
    rng = np.random.default_rng(seed)
    # Sample target degrees ~ Pareto, clipped, rescaled to hit avg_degree.
    w = rng.pareto(exponent - 1.0, size=num_nodes) + 1.0
    w = w / w.mean() * avg_degree
    w = np.clip(w, 0.25, num_nodes / 4)
    num_edges = int(num_nodes * avg_degree)
    p = w / w.sum()
    src = rng.choice(num_nodes, size=num_edges, p=p)
    dst = rng.choice(num_nodes, size=num_edges, p=p)
    keep = src != dst
    return from_edges(num_nodes, src[keep], dst[keep], symmetrize=symmetrize)


def random_community_graph(num_communities: int, community_size: int, *,
                           p_intra: float = 0.3, p_inter_edges_per_node: float = 0.5,
                           seed: int = 0, size_stddev: float = 0.0) -> CSRGraph:
    """Planted-partition graph: dense intra-community, sparse inter-community.

    This is the structure §4.1.3 exploits; the estimating strategy (§7.2)
    profiles exactly such synthetic communities at 90/70/50% densities.
    ``size_stddev`` > 0 produces irregular community sizes (the `artist`
    pathology from §8.6.2).
    """
    rng = np.random.default_rng(seed)
    if size_stddev > 0:
        sizes = np.maximum(2, rng.normal(community_size, size_stddev, num_communities).astype(int))
    else:
        sizes = np.full(num_communities, community_size, dtype=int)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offsets[-1])
    srcs, dsts = [], []
    for c in range(num_communities):
        lo, hi = offsets[c], offsets[c + 1]
        sz = hi - lo
        # intra-community Erdos-Renyi(p_intra)
        m = int(p_intra * sz * (sz - 1) / 2)
        if m > 0:
            a = rng.integers(lo, hi, size=m)
            b = rng.integers(lo, hi, size=m)
            keep = a != b
            srcs.append(a[keep]); dsts.append(b[keep])
    # inter-community random edges
    m = int(p_inter_edges_per_node * n)
    if m > 0:
        a = rng.integers(0, n, size=m)
        b = rng.integers(0, n, size=m)
        keep = a != b
        srcs.append(a[keep]); dsts.append(b[keep])
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    return from_edges(n, src, dst, symmetrize=True)


def grid_graph(rows: int, cols: int) -> CSRGraph:
    """Deterministic 2-D grid graph (handy for exact-value tests)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    src, dst = [], []
    for (a, b) in [(idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :])]:
        src.append(a.ravel()); dst.append(b.ravel())
    return from_edges(rows * cols, np.concatenate(src), np.concatenate(dst), symmetrize=True)
