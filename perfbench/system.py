"""The system under test as the drivers reach it: the port's GNN built
on the benchmark's graph (`repro_torch.models.gnn.build_gnn`: the
advisor's extractor, tuner and partition, then the plan executor), and
the node order the plan runs in.

The port may renumber the graph (``plan.perm[old] = new``); the
benchmark's inputs and the reference stay in the graph's own order, so
inputs enter the plan's order here and outputs leave it here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["System", "build_system"]


@dataclasses.dataclass
class System:
    model: object                       # repro_torch.models.gnn.GNNModel
    plan_s: float
    inv_perm: Optional[torch.Tensor]    # plan row -> graph node
    perm: Optional[torch.Tensor]        # graph node -> plan row

    def to_plan(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.inv_perm is None else x[self.inv_perm]

    def from_plan(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.perm is None else x[self.perm.to(x.device)]


def build_system(ctx, *, with_backward: bool) -> System:
    """Plan the graph and build the model on the card, timed on the host
    clock closed by a synchronise (the per-layer metric ``plan_s``)."""
    from repro_torch.graphs.csr import CSRGraph
    from repro_torch.models.gnn import GNNConfig, build_gnn

    # every key of the configuration's model that the port's config has
    names = {f.name for f in dataclasses.fields(GNNConfig)}
    cfg = GNNConfig(**{k: v for k, v in ctx.config["model"].items()
                       if k in names},
                    backend=ctx.backend, device=str(ctx.device))
    g = CSRGraph(ctx.graph.indptr, ctx.graph.indices)
    t = time.perf_counter()
    model = build_gnn(g, cfg, seed=ctx.config["advisor"]["seed"],
                      with_backward=with_backward)
    ctx.sync()
    plan_s = time.perf_counter() - t
    perm = inv = None
    if model.plan.perm is not None:
        p = np.asarray(model.plan.perm, np.int64)
        perm = torch.as_tensor(p, device=ctx.device)
        inv = torch.as_tensor(np.argsort(p), device=ctx.device)
    return System(model=model, plan_s=plan_s, inv_perm=inv, perm=perm)
