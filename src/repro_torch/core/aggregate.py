"""High-level aggregation API used by GNN layers.

Port of `src/repro/core/aggregate.py`: bridges a `Plan` (advisor output)
to a callable that aggregates tensors on one device.  When the plan
carries a backward partition (`plan_for(with_backward=True)`), every call
is differentiable on every backend: the backward re-aggregates the output
cotangent over the transposed schedule (see `repro_torch.kernels.ops`).
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import Plan
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import aggregate as _kernel_aggregate

__all__ = ["PlanExecutor"]


class PlanExecutor:
    """Executable aggregation bound to one plan (device-resident schedule).

    backend : "cuda" (the hand-written kernels, default) | "torch" (the
        plain PyTorch version) — see `repro_torch.kernels.ops`.
    device : where the schedule lives and the features must be
        ("cuda" by default; raises on a machine without CUDA unless
        "cpu" is passed).
    """

    def __init__(self, plan: Plan, *, backend: str = "cuda", device="cuda"):
        self.plan = plan
        self.device = resolve_device(device)
        self.sched = plan.sched(self.device)
        self.sched_bwd = plan.sched_bwd(self.device)
        self.backend = backend
        self.dt = plan.config.dt
        self.variant = plan.config.variant
        # outputs follow the plan's dtype policy (f32 accumulation inside)
        self.out_dtype = getattr(torch, plan.config.feat_dtype)

    def __call__(self, feat: torch.Tensor) -> torch.Tensor:
        """feat: (N, D) in the plan's (renumbered) node order -> (N, D) in
        the plan's ``feat_dtype``."""
        return _kernel_aggregate(feat, self.sched, dt=self.dt,
                                 backend=self.backend, variant=self.variant,
                                 sched_bwd=self.sched_bwd,
                                 out_dtype=self.out_dtype)

    def aggregate_edges(self, feat: torch.Tensor,
                        edge_values: torch.Tensor) -> torch.Tensor:
        """Aggregation with DYNAMIC per-edge weights (original CSR edge
        order of the plan's graph) — the GAT path: the schedule is reused,
        only the edge-value tensor is re-scattered per forward.  With a
        backward schedule, gradients flow to BOTH ``feat`` (transposed
        aggregation) and ``edge_values`` (per-edge gather-dot)."""
        return _kernel_aggregate(feat, self.sched, dt=self.dt,
                                 backend=self.backend, variant=self.variant,
                                 edge_values=edge_values,
                                 sched_bwd=self.sched_bwd,
                                 out_dtype=self.out_dtype)
