"""Input extractor (paper §4, Fig. 1 "Input Extractor").

Port of `src/repro/core/extractor.py` (carried over verbatim).

Squeezes input-level information out of (graph, GNN architecture) that drives
every downstream decision:

  * node-degree statistics  -> group size selection (§5.1, Eq. 2 alpha term)
  * embedding dimensionality -> dimension-tile width (§5.4) and agg ordering
  * community statistics     -> whether renumbering pays off (§6.1, §8.6.2)
  * GNN architecture type    -> aggregation placement (§4.2): type-1
    (GCN-like, order-independent, reduce-dim-first) vs type-2 (GIN/GAT-like,
    edge-valued, full-dim aggregation).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.csr import CSRGraph

__all__ = ["GraphProps", "GNNArchProps", "extract_graph_props", "extract_arch_props"]


@dataclasses.dataclass(frozen=True)
class GraphProps:
    num_nodes: int
    num_edges: int
    avg_degree: float
    max_degree: int
    degree_stddev: float
    # power-law-ness proxy: stddev/mean of degrees (coefficient of variation)
    degree_cv: float
    # community proxy from a cheap label-propagation pass:
    num_communities: int
    community_size_mean: float
    community_size_stddev: float
    # locality of the *current* numbering: mean |u - v| over edges, normalized.
    numbering_spread: float

    @property
    def alpha(self) -> float:
        """Paper §7.1: alpha in [0.15, 0.3], larger for higher degree stddev."""
        cv = min(self.degree_cv, 3.0)
        return 0.15 + 0.15 * (cv / 3.0)


@dataclasses.dataclass(frozen=True)
class GNNArchProps:
    """GNN architecture info (paper §4.2)."""

    name: str
    agg_type: int  # 1 = order-independent plain (GCN); 2 = edge-valued (GIN/GAT)
    in_dim: int
    hidden_dim: int
    num_layers: int
    reduce_dim_first: bool  # type 1 => True (aggregate after W projection)


def _label_propagation_communities(g: CSRGraph, *, rounds: int = 5,
                                   seed: int = 0) -> np.ndarray:
    """Cheap community labels via synchronous label propagation.

    Lightweight by design — the paper stresses renumbering must stay cheap
    (§6.1: "lightweight in its computation and memory cost").
    """
    n = g.num_nodes
    labels = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    order = np.arange(n)
    for _ in range(rounds):
        rng.shuffle(order)
        changed = 0
        for v in order:
            nbrs = g.neighbors(v)
            if len(nbrs) == 0:
                continue
            lab = labels[nbrs]
            # most frequent neighbor label
            vals, counts = np.unique(lab, return_counts=True)
            best = vals[np.argmax(counts)]
            if best != labels[v]:
                labels[v] = best
                changed += 1
        if changed == 0:
            break
    # compact labels
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def extract_graph_props(g: CSRGraph, *, detect_communities: bool = True,
                        community_sample_cap: int = 20_000) -> GraphProps:
    degs = g.degrees
    n, e = g.num_nodes, g.num_edges
    mean_deg = float(degs.mean()) if n else 0.0
    std_deg = float(degs.std()) if n else 0.0
    if detect_communities and n > 0:
        if n > community_sample_cap:
            # sample an induced subgraph for community stats only
            sub = _induced_subgraph(g, community_sample_cap)
            labels = _label_propagation_communities(sub)
        else:
            labels = _label_propagation_communities(g)
        _, sizes = np.unique(labels, return_counts=True)
        ncomm = len(sizes)
        cmean, cstd = float(sizes.mean()), float(sizes.std())
    else:
        ncomm, cmean, cstd = 1, float(n), 0.0
    if e > 0:
        rows, cols = g.to_coo()
        spread = float(np.abs(rows.astype(np.int64) - cols.astype(np.int64)).mean()) / max(n, 1)
    else:
        spread = 0.0
    return GraphProps(
        num_nodes=n, num_edges=e, avg_degree=mean_deg,
        max_degree=int(degs.max()) if n else 0,
        degree_stddev=std_deg,
        degree_cv=std_deg / mean_deg if mean_deg > 0 else 0.0,
        num_communities=ncomm, community_size_mean=cmean,
        community_size_stddev=cstd, numbering_spread=spread,
    )


def _induced_subgraph(g: CSRGraph, k: int) -> CSRGraph:
    """First-k-nodes induced subgraph (cheap, preserves local structure)."""
    indptr = g.indptr[: k + 1].copy()
    out_indices = []
    out_ptr = [0]
    for v in range(k):
        nbrs = g.neighbors(v)
        nbrs = nbrs[nbrs < k]
        out_indices.append(nbrs)
        out_ptr.append(out_ptr[-1] + len(nbrs))
    idx = np.concatenate(out_indices) if out_indices else np.zeros(0, np.int32)
    return CSRGraph(np.asarray(out_ptr, dtype=np.int64), idx.astype(np.int32))


def extract_arch_props(name: str, in_dim: int, hidden_dim: int,
                       num_layers: int) -> GNNArchProps:
    name_l = name.lower()
    if name_l in ("gcn", "graphsage", "sage"):
        agg_type = 1
    elif name_l in ("gin", "gat"):
        agg_type = 2
    else:
        raise ValueError(f"unknown GNN architecture {name!r}")
    return GNNArchProps(
        name=name_l, agg_type=agg_type, in_dim=in_dim, hidden_dim=hidden_dim,
        num_layers=num_layers, reduce_dim_first=(agg_type == 1),
    )
