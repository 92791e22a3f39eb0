"""Deterministic Zipf seed popularity for the serving driver.

Port of `zipf_seeds` from `src/repro/serving/loadgen.py` (carried over
verbatim).  A skewed hot set is what makes plan caching pay off in
production, per the paper's amortization thesis.  The async tier's
schedule builder waits for its slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["zipf_seeds"]


def zipf_seeds(num_nodes: int, requests: int, *, zipf: float = 1.1,
               hot_fraction: float = 0.05, seed: int = 0,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Zipf-popularity seed nodes: ranks Zipf-weighted over a random node
    permutation, so a small hot set dominates the trace."""
    rng = np.random.default_rng(seed) if rng is None else rng
    pool = max(1, int(num_nodes * hot_fraction))
    nodes = rng.permutation(num_nodes)[:pool]
    ranks = np.arange(1, pool + 1, dtype=np.float64)
    p = ranks ** (-zipf)
    p /= p.sum()
    return nodes[rng.choice(pool, size=requests, p=p)]

