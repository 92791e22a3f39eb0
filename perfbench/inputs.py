"""A run's inputs, made on the device from ``--seed``: features, labels,
the train mask and the weights, each in one call of one generator.  The
same seed gives the same inputs on the same device; the port and the
reference get the same tensors."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["make_inputs"]


def make_inputs(arch, config: dict, seed: int, num_nodes: int,
                mean_degree: float, device) -> Dict[str, object]:
    """``{"feat", "labels", "mask", "params"}`` in the graph's own node
    order, the weights named and shaped by ``arch.param_shapes``.
    Weights are N(0, 1/fan_in); each layer's first matrix is further
    multiplied by (1 + mean degree) **
    -``init["first_matrix_degree_power"]``."""
    model = config["model"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    n = num_nodes
    feat = torch.randn((n, model["in_dim"]), generator=gen, device=device)
    labels = torch.randint(0, model["num_classes"], (n,), generator=gen,
                           device=device)
    mask = (torch.rand((n,), generator=gen, device=device)
            < config["train_fraction"]).float()
    shapes = arch.param_shapes(model)
    flat = torch.randn((sum(a * b for _, (a, b), _ in shapes),),
                       generator=gen, device=device)
    params, at = {}, 0
    gain = (1.0 + mean_degree) ** -config["init"]["first_matrix_degree_power"]
    for name, (a, b), first in shapes:
        scale = (gain if first else 1.0) / np.sqrt(a)
        params[name] = (flat[at:at + a * b] * scale).reshape(a, b)
        at += a * b
    return {"feat": feat, "labels": labels, "mask": mask, "params": params}
