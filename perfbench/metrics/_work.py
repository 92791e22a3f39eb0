"""The work a step or a request needs, counted from the model's
mathematics, the configuration and the benchmark's CSR alone, never from
the port's plan or kernels: the same work whatever implements it.

Aggregation calls (one per layer forward; in training, one more per
layer whose input needs a gradient) and dense products come from the
architecture's module (`perfbench/arch/<arch>.py`: ``agg_widths``,
``products``, and whether the aggregated graph has self-loops and
weighted edges).

A call of width D over E edges and N nodes needs, at the least:
  bytes = E * (4 id + 4 value if weighted) + 8 (N + 1) indptr
          + itemsize * D * (source rows, each read once)
          + itemsize * D * N (each output row written once)
  FLOPs = E * D * (2 if weighted: multiply and add; 1 if not: add).
Model FLOPs add every dense product, 2 N d_in d_out, forward and in
training the backward products autograd needs (dW always, dX where the
input needs a gradient).  Elementwise work, the loss and AdamW are left
out of the FLOPs.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from perfbench.metrics import _peaks

__all__ = ["AggCall", "agg_calls", "agg_least_seconds", "call_bytes",
           "call_flops", "model_flops"]

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclasses.dataclass(frozen=True)
class AggCall:
    width: int
    edges: int
    nodes: int
    sources: int          # nodes with an out-edge: rows the call reads
    weighted: bool
    itemsize: int


def agg_calls(arch, model: dict, graph, kind: str) -> List[AggCall]:
    """The aggregation calls of one step (``kind`` "train") or one
    request ("infer") of ``model``, whose architecture module is
    ``arch``, on ``graph`` (a CSR with ``indptr``, ``indices``,
    ``num_nodes``, ``num_edges``)."""
    n = graph.num_nodes
    item = _ITEMSIZE[model["feat_dtype"]]
    if arch.SELF_LOOPS:
        edges, src = graph.num_edges + n, n
    else:
        edges = graph.num_edges
        src = int(np.count_nonzero(np.bincount(graph.indices, minlength=n)))
    return [AggCall(d, edges, n, src, arch.WEIGHTED, item)
            for d in arch.agg_widths(model, kind)]


def call_bytes(c: AggCall) -> float:
    per_edge = 8 if c.weighted else 4
    return (c.edges * per_edge + 8 * (c.nodes + 1)
            + c.itemsize * c.width * (c.sources + c.nodes))


def call_flops(c: AggCall) -> float:
    return c.edges * c.width * (2 if c.weighted else 1)


def agg_least_seconds(calls: List[AggCall]) -> float:
    """Sum over calls of the larger of bytes / HBM bandwidth and FLOPs /
    the float32 peak."""
    return sum(max(call_bytes(c) / _peaks.HBM_BYTES_PER_S,
                   call_flops(c) / _peaks.F32_FLOP_PER_S) for c in calls)


def model_flops(arch, model: dict, graph, kind: str) -> float:
    """FLOPs of one step or request: dense products plus aggregation."""
    n = graph.num_nodes
    total = 0.0
    for d_in, d_out, needs in arch.products(model):
        one = 2.0 * n * d_in * d_out
        total += one
        if kind == "train":
            total += one * (2 if needs else 1)
    return total + sum(call_flops(c)
                       for c in agg_calls(arch, model, graph, kind))
