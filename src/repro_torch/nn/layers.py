"""Parameter initializer and RMS norm of the LM layers.

Port of `src/repro/nn/layers.py`: `Initializer.weight` (:102), `rmsnorm`
(:136) and `apply_rmsnorm` (:141).  The reference's sharding rules have no
counterpart here (sharding waits for its slice), so a weight is a tensor
alone, not a (tensor, spec) pair.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["Initializer", "rmsnorm", "apply_rmsnorm"]


class Initializer:
    """Fan-in-scaled normal weights from a `torch.Generator`.

    ``shape[-2]`` is the fan-in (``shape[-1]`` for a vector), as in the
    reference; ``scale`` overrides ``1/sqrt(fan_in)``, ``zero=True`` gives
    zeros.  The draw is float32, then cast to ``dtype``.  On the ``meta``
    device every weight is a shape alone and nothing is drawn or
    allocated.  Same shapes and scales as the reference; the numbers
    differ (another generator)."""

    def __init__(self, generator: Optional[torch.Generator], *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.gen = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def weight(self, shape, *, scale: Optional[float] = None,
               zero: bool = False) -> torch.Tensor:
        if zero or self.device.type == "meta":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (w * s).to(self.dtype)


def rmsnorm(init: Initializer, dim: int) -> dict:
    """Gemma-style ``(1 + g)`` gain, zero-initialized."""
    return {"g": init.weight((dim,), zero=True)}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + p["g"].float())
    return y.to(x.dtype)
