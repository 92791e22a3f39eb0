"""GIN (Xu et al., arXiv:1810.00826) as the benchmark builds, counts and
checks it; found by a configuration's ``model.arch``.

    H' = MLP((1 + eps) H + sum of the neighbours' H),

the MLP two matrices with a ReLU between; no batch norm (the port has
none, so the reference leaves it out too).  Each layer aggregates its
input, unweighted, at the input's width: in_dim, then hidden.  Layer
0's input is the constant features, so training has no backward call
there.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from perfbench.reference.gnn import Adjacency

# the aggregated graph: the plain adjacency, unweighted, no self-loops
SELF_LOOPS = False
WEIGHTED = False


def dims(model: dict) -> List[int]:
    h = model["hidden_dim"]
    return ([model["in_dim"]] + [h] * (model["num_layers"] - 1)
            + [model["num_classes"]])


def param_shapes(model: dict) -> List[Tuple[str, Tuple[int, int], bool]]:
    """``(name, shape, first)`` of each weight, by the port's key names:
    ``w{i}`` (dims[i] x hidden), the layer's first matrix, and ``w{i}b``
    (hidden x dims[i+1])."""
    d, h = dims(model), model["hidden_dim"]
    out = []
    for i in range(model["num_layers"]):
        out.append((f"w{i}", (d[i], h), True))
        out.append((f"w{i}b", (h, d[i + 1]), False))
    return out


def adjacency(indptr, indices, device) -> Adjacency:
    return Adjacency(indptr, indices, gcn_norm=False, device=device)


def logits(model: dict, params, x: torch.Tensor, adj: Adjacency,
           matmul: Callable = torch.matmul) -> torch.Tensor:
    """The plain reference's (N, num_classes) logits on features ``x``."""
    for i in range(model["num_layers"]):
        h = (1.0 + model["gin_eps"]) * x + adj(x)
        x = matmul(torch.relu(matmul(h, params[f"w{i}"])), params[f"w{i}b"])
    return x


def agg_widths(model: dict, kind: str) -> List[int]:
    """Widths of the aggregation calls of one step ("train") or one
    request ("infer")."""
    fwd = dims(model)[:-1]
    return fwd + (fwd[1:] if kind == "train" else [])


def products(model: dict) -> List[Tuple[int, int, bool]]:
    """``(d_in, d_out, input_needs_grad)`` of each dense product."""
    d, h = dims(model), model["hidden_dim"]
    out = []
    for i in range(model["num_layers"]):
        out.append((d[i], h, i > 0))
        out.append((h, d[i + 1], True))
    return out
