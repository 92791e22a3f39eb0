"""High-level aggregation API used by GNN layers.

Port of `src/repro/core/aggregate.py`: bridges a `Plan` (advisor output)
to a callable that aggregates tensors on one device.  When the plan
carries a backward partition (`plan_for(with_backward=True)`), every call
is differentiable on every backend: the backward re-aggregates the output
cotangent over the transposed schedule (see `repro_torch.kernels.ops`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.plan import Plan
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import DeviceSchedule
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
        # the renumber permutation (perm[old] = new) and its inverse, on
        # the device once, for `aggregate_original_order`
        self._perm = self._inv_perm = None
        if plan.perm is not None:
            perm = np.asarray(plan.perm, np.int64)
            self._perm = torch.as_tensor(perm, device=self.device)
            self._inv_perm = torch.as_tensor(np.argsort(perm),
                                             device=self.device)

    @classmethod
    def from_schedule(cls, sched: DeviceSchedule, *, dt: int, variant: str,
                      backend: str = "cuda", device="cuda",
                      sched_bwd: Optional[DeviceSchedule] = None,
                      out_dtype="float32") -> "PlanExecutor":
        """Plan-less executor over a bare schedule (the reference's
        `PlanExecutor.from_schedule`): the measured tuner runs one schedule
        under several gather variants, and `profile_plan` the transposed
        schedule alone, without building new plans.

        sched : a `DeviceSchedule` on ``device``.
        dt : dim-tile width handed to the kernel (clamped to the feature
            width at call time).
        variant : "folded" | "slot_onehot" | "direct".
        sched_bwd : optional TRANSPOSED-graph schedule; with it the
            executor is differentiable on every backend.
        out_dtype : dtype (name) of the outputs — the plan's
            ``AggConfig.feat_dtype`` policy; accumulation is f32 always.
        """
        ex = cls.__new__(cls)
        ex.plan = None
        ex.device = resolve_device(device)
        if sched.device != ex.device:
            raise ValueError(f"schedule is on {sched.device}, executor on "
                             f"{ex.device}")
        ex.sched = sched
        ex.sched_bwd = sched_bwd
        ex.backend = backend
        ex.dt = dt
        ex.variant = variant
        ex.out_dtype = getattr(torch, out_dtype)
        ex._perm = ex._inv_perm = None
        return ex

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

    def aggregate_original_order(self, feat_original: torch.Tensor
                                 ) -> torch.Tensor:
        """`__call__` on features in the ORIGINAL (pre-renumber) node order,
        returning rows in that order: ``feat[inv_perm]`` enters the plan's
        order and ``out[perm]`` leaves it (``perm[old] = new``).  Plans
        without a permutation, and `from_schedule` executors, aggregate
        the input as given."""
        if self._perm is None:
            return self(feat_original)
        out = self(feat_original[self._inv_perm])
        return out[self._perm]
