"""The configurations' graph: a synthetic replica at a published size.

A copy of the port's replica generator (`repro_torch.graphs.csr:
random_power_law` and `from_edges`, as `repro_torch.graphs.datasets`
calls them for a Type III graph), kept here so that the benchmark's graph
cannot change with the program.  Numpy only; the result is a CSR whose
row v lists the nodes v aggregates from.

The full reddit replica takes about ten seconds to generate, so it is
written once per checkout under `.cache/` (a fixed path named by the
graph's parameters) and read back by later runs.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
from typing import Optional

import numpy as np

__all__ = ["CACHE_DIR", "Graph", "load_graph", "power_law"]

CACHE_DIR = pathlib.Path(__file__).resolve().parent / ".cache"


class Graph:
    """CSR adjacency: ``indptr`` (N+1,) int64, ``indices`` (E,) int32."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int32)
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("indptr does not bound indices")

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    s = np.sort(a)
    if len(s) == 0:
        return s
    keep = np.empty(len(s), dtype=bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def _from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                symmetrize: bool) -> Graph:
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = _sorted_unique(dst * n + src)       # dedup; rows ascend
    dst, src = key // n, key % n
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(dst, minlength=n))
    return Graph(indptr, src.astype(np.int32))


def power_law(num_nodes: int, avg_degree: float, exponent: float, seed: int,
              symmetrize: bool) -> Graph:
    """Chung-Lu sampler with Pareto target degrees: ``num_nodes *
    avg_degree`` draws, self-loops dropped, mirrored when ``symmetrize``,
    duplicates merged."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(exponent - 1.0, size=num_nodes) + 1.0
    w = w / w.mean() * avg_degree
    w = np.clip(w, 0.25, num_nodes / 4)
    draws = int(num_nodes * avg_degree)
    p = w / w.sum()
    src = rng.choice(num_nodes, size=draws, p=p)
    dst = rng.choice(num_nodes, size=draws, p=p)
    keep = src != dst
    return _from_edges(num_nodes, src[keep], dst[keep], symmetrize)


def load_graph(spec: dict, *, num_nodes: Optional[int] = None,
               cache_dir: Optional[pathlib.Path] = CACHE_DIR) -> Graph:
    """The graph a configuration's ``graph`` entry describes.

    ``num_nodes`` scales the replica down (nodes and edges alike, the
    mean degree kept); tests use it.  ``cache_dir`` None generates
    without reading or writing a cache."""
    if spec["generator"] != "power_law":
        raise ValueError(f"unknown graph generator {spec['generator']!r}")
    n = spec["num_nodes"] if num_nodes is None else int(num_nodes)
    args = dict(num_nodes=n,
                avg_degree=spec["num_edges"] / spec["num_nodes"],
                exponent=spec["exponent"],
                seed=spec["seed"], symmetrize=spec["symmetrize"])
    if cache_dir is None:
        return power_law(**args)
    key = hashlib.sha256(json.dumps(args, sort_keys=True).encode())
    path = pathlib.Path(cache_dir) / f"graph-{key.hexdigest()[:16]}.npz"
    if path.exists():
        with np.load(path) as z:
            return Graph(z["indptr"], z["indices"])
    g = power_law(**args)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, indptr=g.indptr, indices=g.indices)
    os.replace(tmp, path)      # a concurrent reader never sees half a file
    return g
