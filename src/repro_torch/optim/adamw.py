"""AdamW + learning-rate schedules + global-norm clipping.

Port of `src/repro/optim/adamw.py`, with its semantics: float32 moments,
clipping by the global norm BEFORE the moments, bias correction, and
decoupled weight decay on matrices only (``ndim >= 2``).  Parameters,
gradients and moments are ``dict[str, torch.Tensor]`` (the model's
parameter dict); leaves are visited in sorted key order, the order
`jax.tree_util` flattens a dict in, so sums match the reference's order.
The update returns new tensors and leaves its inputs untouched, as the
reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
Step = Union[int, torch.Tensor]

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "global_norm", "clip_by_global_norm", "cosine_schedule",
           "linear_warmup", "opt_state_from_jax"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    schedule: Optional[Callable[[Step], torch.Tensor]] = None


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Tree              # first moment (f32)
    v: Tree              # second moment (f32)


def adamw_init(params: Tree) -> OptState:
    """Zero moments beside each parameter, step 0 on the parameters'
    device."""
    dev = next(iter(params.values())).device if params else None
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros, v={k: z.clone() for k, z in zeros.items()})


def opt_state_from_jax(state, device) -> OptState:
    """Carry a reference ``OptState(step, m, v)`` across (anything with
    those fields whose leaves `np.asarray` takes): float32 moments and an
    int32 step on ``device``, under the same keys."""
    def tree(t):
        return {k: torch.tensor(np.asarray(v, dtype=np.float32),
                                device=device) for k, v in t.items()}
    return OptState(step=torch.tensor(int(np.asarray(state.step)),
                                      dtype=torch.int32, device=device),
                    m=tree(state.m), v=tree(state.v))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / norm)``; returns
    ``(clipped, norm)``."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gn


def adamw_update(cfg: AdamWConfig, grads: Tree, state: OptState,
                 params: Tree):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``;
    metrics ``grad_norm`` (before clipping) and ``lr`` are 0-d tensors."""
    g32 = {k: g.float() for k, g in grads.items()}
    if cfg.grad_clip is not None:
        g32, gn = clip_by_global_norm(g32, cfg.grad_clip)
    else:
        gn = global_norm(g32)
    step = state.step + 1
    sf = step.float()
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None
                   else torch.ones((), device=sf.device))
    c1 = 1.0 - cfg.b1 ** sf
    c2 = 1.0 - cfg.b2 ** sf
    new_p, new_m, new_v = {}, {}, {}
    for k in sorted(params):
        p, g = params[k], g32[k]
        m = cfg.b1 * state.m[k] + (1 - cfg.b1) * g
        v = cfg.b2 * state.v[k] + (1 - cfg.b2) * g * g
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.ndim >= 2:          # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return (new_p, OptState(step=step, m=new_m, v=new_v),
            {"grad_norm": gn, "lr": lr})


def _as_f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(warmup: int) -> Callable[[Step], torch.Tensor]:
    def f(step):
        return torch.clamp(_as_f32(step) / max(warmup, 1), max=1.0)
    return f


def cosine_schedule(warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[Step], torch.Tensor]:
    """Linear warmup to 1 over ``warmup`` steps, then cosine decay to
    ``final_frac`` at ``total``."""
    def f(step):
        s = _as_f32(step)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f
