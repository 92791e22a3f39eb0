"""Synthetic replicas of the paper's evaluation datasets (Table 1).

Port of `src/repro/graphs/datasets.py` (numpy only; `interaction_stream`
waits for the mutable-graph slice).

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
from typing import Dict

import numpy as np

from repro_torch.graphs.csr import CSRGraph, random_community_graph, random_power_law

__all__ = ["DatasetSpec", "PAPER_DATASETS", "make_dataset", "dataset_names"]


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
    rng = np.random.default_rng(seed + 1)
    dim = spec.dim if max_dim is None else min(spec.dim, max_dim)
    feat = rng.standard_normal((g.num_nodes, dim)).astype(np.float32)
    return g, spec, feat

