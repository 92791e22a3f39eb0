"""Synthetic replicas of the paper's evaluation datasets (Table 1).

Port of `src/repro/graphs/datasets.py` (numpy only, carried over verbatim).

The paper's graphs are not shipped offline, so each entry regenerates a
synthetic graph matching the published (N, E, D, #classes) and the structural
property its type exemplifies:

  Type I   — small N/E, very high embedding dim (citation graphs): power-law.
  Type II  — batched small graphs, block-diagonal adjacency, consecutive IDs
             inside each small graph (the built-in locality §8.2 discusses):
             community graph with zero inter-community edges.
  Type III — large irregular graphs: power-law with heavy skew (+ one
             irregular-community variant for `artist`).

Every property GNNAdvisor's runtime consumes (degree skew, community
structure, dimensionality, scale) is preserved; the actual node features are
random, which is irrelevant to runtime behaviour.

Sizes are scaled by `scale` (default keeps the paper's N for small graphs and
caps large ones for CPU-friendliness — pass scale=1.0 for full size).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np

from repro_torch.graphs.csr import CSRGraph, random_community_graph, random_power_law

__all__ = ["DatasetSpec", "PAPER_DATASETS", "make_dataset", "dataset_names",
           "interaction_stream"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    num_edges: int
    dim: int
    num_classes: int
    gtype: str  # "I" | "II" | "III"
    community_stddev: float = 0.0  # >0 => irregular communities (artist)


PAPER_DATASETS: Dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        # Type I
        DatasetSpec("citeseer", 3_327, 9_464, 3703, 6, "I"),
        DatasetSpec("cora", 2_708, 10_858, 1433, 7, "I"),
        DatasetSpec("pubmed", 19_717, 88_676, 500, 3, "I"),
        DatasetSpec("ppi", 56_944, 818_716, 50, 121, "I"),
        # Type II
        DatasetSpec("proteins_full", 43_471, 162_088, 29, 2, "II"),
        DatasetSpec("ovcar-8h", 1_890_931, 3_946_402, 66, 2, "II"),
        DatasetSpec("yeast", 1_714_644, 3_636_546, 74, 2, "II"),
        DatasetSpec("dd", 334_925, 1_686_092, 89, 2, "II"),
        DatasetSpec("twitter-partial", 580_768, 1_435_116, 1323, 2, "II"),
        DatasetSpec("sw-620h", 1_889_971, 3_944_206, 66, 2, "II"),
        # Type III
        DatasetSpec("reddit", 232_965, 11_606_919, 602, 41, "III"),
        DatasetSpec("amazon0505", 410_236, 4_878_875, 96, 22, "III"),
        DatasetSpec("artist", 50_515, 1_638_396, 100, 12, "III", community_stddev=40.0),
        DatasetSpec("com-amazon", 334_863, 1_851_744, 96, 22, "III"),
        DatasetSpec("soc-blogcatalog", 88_784, 2_093_195, 128, 39, "III"),
        DatasetSpec("amazon0601", 403_394, 3_387_388, 96, 22, "III"),
    ]
}


def dataset_names() -> list[str]:
    return list(PAPER_DATASETS)


def make_dataset(name: str, *, scale: float = 1.0, max_nodes: int | None = None,
                 seed: int = 0, max_dim: int | None = None,
                 ) -> tuple[CSRGraph, DatasetSpec, np.ndarray]:
    """Generate (graph, spec, features) for a paper dataset replica.

    `scale` < 1 shrinks N and E proportionally (degree distribution and
    community structure are preserved); `max_nodes` caps N.  `max_dim` caps
    the generated feature width — full-size Type III graphs at their native
    dims (reddit: 233k x 602) would materialize hundreds of MB of features
    a sampled trainer then slices anyway.
    """
    spec = PAPER_DATASETS[name]
    n = int(spec.num_nodes * scale)
    if max_nodes is not None:
        n = min(n, max_nodes)
    n = max(n, 16)
    g = _replica_graph(name, n, seed)
    rng = np.random.default_rng(seed + 1)
    dim = spec.dim if max_dim is None else min(spec.dim, max_dim)
    feat = rng.standard_normal((g.num_nodes, dim)).astype(np.float32)
    return g, spec, feat


@functools.lru_cache(maxsize=4)
def _replica_graph(name: str, n: int, seed: int) -> CSRGraph:
    """The replica's graph at ``n`` nodes, a pure function of its
    arguments, kept for the next call in this process (full reddit takes
    most of a minute to generate); callers do not mutate it."""
    spec = PAPER_DATASETS[name]
    avg_deg = spec.num_edges / spec.num_nodes
    if spec.gtype == "II":
        # batched small graphs: avg component size in these datasets ~ 20-40.
        comm = max(2, min(40, int(np.sqrt(n))))
        g = random_community_graph(
            max(1, n // comm), comm,
            p_intra=min(0.9, avg_deg / max(comm - 1, 1)),
            p_inter_edges_per_node=0.0, seed=seed,
        )
    elif spec.community_stddev > 0:
        comm = 30
        g = random_community_graph(
            max(1, n // comm), comm,
            p_intra=min(0.9, avg_deg / comm),
            p_inter_edges_per_node=avg_deg * 0.25,
            seed=seed, size_stddev=spec.community_stddev,
        )
    else:
        g = random_power_law(n, avg_deg, seed=seed)
    return g


def interaction_stream(g: CSRGraph, *, num_batches: int,
                       edges_per_batch: int, feat_dim: int = 0,
                       new_node_frac: float = 0.05,
                       delete_frac: float = 0.1, seed: int = 0):
    """Deterministic synthetic mutation stream against ``g``: yields
    ``num_batches`` `repro_torch.graphs.delta.GraphDelta`s modelling a
    production interaction log.

    Endpoints follow a power-law popularity distribution drawn from the
    SEED graph's degrees (popular nodes keep getting edges — the skew the
    paper's §4.1.1 input properties describe), ``new_node_frac`` of each
    batch's insertions attach a fresh node (appended ids, random features
    when ``feat_dim`` > 0), and ``delete_frac`` of the batch removes
    edges that existed in the seed snapshot.  The generator tracks the
    running node count so chained deltas stay id-consistent; it never
    inspects the mutated graphs, so batches can be pre-drawn or replayed
    (everything is a pure function of ``seed``).
    """
    from repro_torch.graphs.delta import GraphDelta

    rng = np.random.default_rng((seed, 0xD311A))
    deg = g.degrees.astype(np.float64) + 1.0
    pop = deg / deg.sum()
    rows0 = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees)
    num_nodes = g.num_nodes
    for _ in range(num_batches):
        n_new = int(edges_per_batch * new_node_frac)
        n_del = min(int(edges_per_batch * delete_frac), g.num_edges)
        n_add = max(edges_per_batch - n_del, n_new)
        # popularity-weighted endpoints among the seed nodes; fresh nodes
        # attach their first interactions to popular endpoints
        add_src = rng.choice(g.num_nodes, size=n_add, p=pop)
        add_dst = rng.choice(g.num_nodes, size=n_add, p=pop)
        if n_new:
            new_ids = num_nodes + np.arange(n_new, dtype=np.int64)
            half = rng.random(n_new) < 0.5
            add_src[:n_new] = np.where(half, new_ids, add_src[:n_new])
            add_dst[:n_new] = np.where(half, add_dst[:n_new], new_ids)
        keep = add_src != add_dst
        add_src, add_dst = add_src[keep], add_dst[keep]
        if n_del:
            eid = rng.choice(g.num_edges, size=n_del, replace=False)
            del_src, del_dst = g.indices[eid].astype(np.int64), rows0[eid]
        else:
            del_src = del_dst = None
        feat = (rng.standard_normal((n_new, feat_dim)).astype(np.float32)
                if n_new and feat_dim else None)
        yield GraphDelta(num_new_nodes=n_new, add_src=add_src,
                         add_dst=add_dst, del_src=del_src, del_dst=del_dst,
                         node_feat=feat)
        num_nodes += n_new
