"""Parameter initializer and the dense layers of the LM stack.

Port of `src/repro/nn/layers.py`: `Initializer.weight` (:102), `linear` /
`apply_linear` (:119, :129), `rmsnorm` / `apply_rmsnorm` (:136, :141),
`layernorm` / `apply_layernorm` (:148, :154), `glu_mlp` / `apply_glu_mlp`
(:171, :178) and `mlp` / `apply_mlp` (:184, :194).  The reference's
sharding rules have no counterpart here (sharding waits for its slice),
so a weight is a tensor alone, not a (tensor, spec) pair.

Rounding points follow the reference as XLA compiles it: the projections
run in the activation's dtype (each weight cast to it); the norms, and
the elementwise chain after a projection (bias, activation, gate), run
in float32 and round once to the activation's dtype, as an XLA fusion of
bf16 elementwise ops does.  ``act`` defaults to the reference's: `F.silu`
for the gated MLP and the tanh GELU (`jax.nn.gelu`'s default) for the
plain one.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["DEFAULT_MAPPING", "DEFAULT_RULES", "Initializer",
           "PartitionSpec", "ShardingRules", "linear", "apply_linear",
           "rmsnorm", "apply_rmsnorm", "layernorm", "apply_layernorm",
           "glu_mlp", "apply_glu_mlp", "glu_mlp_axes", "mlp", "apply_mlp",
           "mlp_axes", "norm_axes", "gelu_tanh"]

gelu_tanh = functools.partial(F.gelu, approximate="tanh")


# ---------------------------------------------------------------------------
# sharding rules: logical axis names -> mesh axes
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """How a tensor's dims lie over a mesh: one entry per dim, a mesh
    axis name, a tuple of names (the dim split over their product,
    the first name major) or None (not split); dims past the last
    entry are not split.  The counterpart of
    `jax.sharding.PartitionSpec`, and like it a tuple whose entries are
    canonical: a one-name tuple is the name, an empty one None."""

    def __new__(cls, *entries):
        def canon(e):
            if not isinstance(e, (tuple, list)):
                return e
            return None if not e else e[0] if len(e) == 1 else tuple(e)
        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    def __reduce__(self):
        return PartitionSpec, tuple(self)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical -> physical mesh-axis mapping (the MaxText pattern: layers
    name each weight dim with a logical axis; the rules place it)."""

    mapping: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_MAPPING))

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        phys, used = [], set()
        for name in logical:
            ax = self.mapping.get(name) if name is not None else None
            # never map two dims of one tensor onto the same mesh axis
            flat = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
            if any(a in used for a in flat if a is not None):
                ax = None
            used.update(a for a in flat if a is not None)
            phys.append(ax)
        return PartitionSpec(*phys)

    def replace(self, **updates) -> "ShardingRules":
        return ShardingRules(mapping={**self.mapping, **updates})


DEFAULT_MAPPING = {
    # weight dims
    "embed": "data",          # FSDP / ZeRO-3: model dim of weights over data
    "mlp": "model",           # TP column/row parallel
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,         # replicated when kv < tp (Megatron GQA pattern)
    "head_dim": None,
    "experts": "model",       # EP
    "expert_mlp": "data",     # FSDP inside each expert
    "inner": "model",         # mamba d_inner
    "state": None,
    "conv": None,
    "layers": None,           # the reference's stacked-layer dim
    # activation dims
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "cache_seq": None,
    "cache_kv": None,
}

DEFAULT_RULES = ShardingRules()


class Initializer:
    """Fan-in-scaled normal weights from a `torch.Generator`.

    ``shape[-2]`` is the fan-in (``shape[-1]`` for a vector), as in the
    reference; ``scale`` overrides ``1/sqrt(fan_in)``, ``zero=True`` gives
    zeros, ``dtype`` overrides the initializer's.  The draw is float32,
    then cast.  On the ``meta`` device every weight is a shape alone and
    nothing is drawn or allocated.  Same shapes and scales as the
    reference; the numbers differ (another generator)."""

    def __init__(self, generator: Optional[torch.Generator], *,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.gen = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def weight(self, shape, *, scale: Optional[float] = None,
               zero: bool = False,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self.dtype
        if zero or self.device.type == "meta":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (w * s).to(dtype)


def linear(init: Initializer, in_dim: int, out_dim: int,
           bias: bool = False) -> dict:
    p = {"w": init.weight((in_dim, out_dim))}
    if bias:
        p["b"] = init.weight((out_dim,), zero=True)
    return p


def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_axes(norm: str = "rms") -> dict:
    """Logical axes of `rmsnorm` (``"rms"``) or `layernorm`'s leaves."""
    return ({"g": ("act_embed",)} if norm == "rms"
            else {"g": ("act_embed",), "b": ("act_embed",)})


def rmsnorm(init: Initializer, dim: int) -> dict:
    """Gemma-style ``(1 + g)`` gain, zero-initialized."""
    return {"g": init.weight((dim,), zero=True)}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + p["g"].float())
    return y.to(x.dtype)


def layernorm(init: Initializer, dim: int) -> dict:
    """``(1 + g)`` gain and a bias, both zero-initialized."""
    return {"g": init.weight((dim,), zero=True),
            "b": init.weight((dim,), zero=True)}


def apply_layernorm(p: dict, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps) * (1.0 + p["g"].float())
         + p["b"].float())
    return y.to(x.dtype)


def glu_mlp(init: Initializer, dim: int, hidden: int) -> dict:
    """Gated MLP (SwiGLU / GeGLU): ``wi`` (dim, 2, hidden), so its fan-in
    is 2, as in the reference."""
    return {"wi": init.weight((dim, 2, hidden)),
            "wo": init.weight((hidden, dim))}


def glu_mlp_axes() -> dict:
    return {"wi": ("embed", None, "mlp"), "wo": ("mlp", "embed")}


def apply_glu_mlp(p: dict, x: torch.Tensor,
                  act: Callable = F.silu) -> torch.Tensor:
    wi = p["wi"].to(x.dtype)
    d, _, hidden = wi.shape
    h = (x @ wi.reshape(d, 2 * hidden)).unflatten(-1, (2, hidden))
    gated = (act(h[..., 0, :].float()) * h[..., 1, :].float()).to(x.dtype)
    return gated @ p["wo"].to(x.dtype)


def mlp(init: Initializer, dim: int, hidden: int) -> dict:
    """Plain 2-layer MLP with biases (starcoder2 style)."""
    return {"w1": init.weight((dim, hidden)),
            "b1": init.weight((hidden,), zero=True),
            "w2": init.weight((hidden, dim)),
            "b2": init.weight((dim,), zero=True)}


def mlp_axes() -> dict:
    return {"w1": ("embed", "mlp"), "b1": ("mlp",), "w2": ("mlp", "embed"),
            "b2": ("embed",)}


def apply_mlp(p: dict, x: torch.Tensor,
              act: Callable = gelu_tanh) -> torch.Tensor:
    h = act((x @ p["w1"].to(x.dtype)).float() + p["b1"].float())
    return h.to(x.dtype) @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)
