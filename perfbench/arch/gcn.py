"""GCN (Kipf and Welling, arXiv:1609.02907) as the benchmark builds,
counts and checks it; found by a configuration's ``model.arch``.

    H' = A_hat (H W),  A_hat = D^-1/2 (A + I) D^-1/2,

ReLU between layers, none after the last.  Each layer projects first and
aggregates the projection, so the aggregation runs at the layer's output
width; every projection needs a gradient, so training aggregates each
layer once more over the transposed edges.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from perfbench.reference.gnn import Adjacency

# the aggregated graph: self-loops added, each edge weighted 1/sqrt(d_u d_v)
SELF_LOOPS = True
WEIGHTED = True


def dims(model: dict) -> List[int]:
    h = model["hidden_dim"]
    return ([model["in_dim"]] + [h] * (model["num_layers"] - 1)
            + [model["num_classes"]])


def param_shapes(model: dict) -> List[Tuple[str, Tuple[int, int], bool]]:
    """``(name, shape, first)`` of each weight, by the port's key names:
    ``w{i}`` (dims[i] x dims[i+1]), each its layer's first matrix."""
    d = dims(model)
    return [(f"w{i}", (d[i], d[i + 1]), True)
            for i in range(model["num_layers"])]


def adjacency(indptr, indices, device) -> Adjacency:
    return Adjacency(indptr, indices, gcn_norm=True, device=device)


def logits(model: dict, params, x: torch.Tensor, adj: Adjacency,
           matmul: Callable = torch.matmul) -> torch.Tensor:
    """The plain reference's (N, num_classes) logits on features ``x``."""
    layers = model["num_layers"]
    for i in range(layers):
        x = adj(matmul(x, params[f"w{i}"]))
        if i < layers - 1:
            x = torch.relu(x)
    return x


def agg_widths(model: dict, kind: str) -> List[int]:
    """Widths of the aggregation calls of one step ("train") or one
    request ("infer")."""
    fwd = dims(model)[1:]
    return fwd + (fwd if kind == "train" else [])


def products(model: dict) -> List[Tuple[int, int, bool]]:
    """``(d_in, d_out, input_needs_grad)`` of each dense product."""
    d = dims(model)
    return [(d[i], d[i + 1], i > 0) for i in range(model["num_layers"])]
