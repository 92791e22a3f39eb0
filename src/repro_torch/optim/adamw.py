"""AdamW + learning-rate schedules + global-norm clipping.

Port of `src/repro/optim/adamw.py`, with its semantics: float32 moments,
clipping by the global norm BEFORE the moments, bias correction, and
decoupled weight decay on matrices only (``ndim >= 2``; a caller whose
leaves differ in rank from the reference's passes ``decay``).  Parameters,
gradients and moments are trees: the GNN's flat ``dict[str, Tensor]`` or
the LM's nested ``{"embed", "blocks": [tuple of dicts], ...}``.  Leaves
are visited in `jax.tree_util`'s order (dict keys sorted, tuples and
lists in order; `runtime.checkpoint._leaves`), so sums match the
reference's order.  `adamw_update` returns new tensors and leaves its
inputs untouched, as the reference's does; `adamw_update_` writes the new
parameters and moments into the given ones, leaf by leaf (the analogue of
the reference's donated train-step buffers), with the same arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.runtime.checkpoint import _leaves, _rebuild

Tree = Any
Step = Union[int, torch.Tensor]

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "adamw_update_", "global_norm", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup", "opt_state_from_jax"]


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


def _tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), as a tree shaped like ``tree``."""
    return _rebuild(tree, iter([fn(*ls) for ls in zip(
        _leaves(tree), *(_leaves(r) for r in rest))]))


def adamw_init(params: Tree) -> OptState:
    """Zero moments beside each parameter, step 0 on the parameters'
    device."""
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=_tree_map(zeros, params), v=_tree_map(zeros, params))


def opt_state_from_jax(state, device) -> OptState:
    """Carry a reference ``OptState(step, m, v)`` of a flat parameter dict
    across (anything with those fields whose leaves `np.asarray` takes):
    float32 moments and an int32 step on ``device``, under the same
    keys."""
    def tree(t):
        return {k: torch.tensor(np.asarray(v, dtype=np.float32),
                                device=device) for k, v in t.items()}
    return OptState(step=torch.tensor(int(np.asarray(state.step)),
                                      dtype=torch.int32, device=device),
                    m=tree(state.m), v=tree(state.v))


def global_norm(tree: Tree, *, specs: Optional[Tree] = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.

    Inside a rank of a mesh (``mesh`` its `AxisGroups`, ``specs`` the
    leaves' pruned `PartitionSpec`s, ``tree`` the rank's slices): the
    norm of the whole tree, each distinct slice counted once (a leaf
    held whole over some axes counts ``1 / size`` on each of their
    ranks), by one all-reduce over every axis; the same on every
    rank."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in _leaves(tree)))
    from repro_torch.distributed.sharding import split_axes, tree_leaves
    total = mesh.size(mesh.axis_names)
    parts = [torch.sum(torch.square(x.float()))
             * (mesh.size(split_axes(sp)) / total)
             for x, sp in zip(tree_leaves(tree), tree_leaves(specs))]
    sq = mesh.all_reduce(torch.stack(parts), mesh.axis_names)
    return torch.sqrt(sum(sq.unbind(0)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / norm)``; returns
    ``(clipped, norm)``."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return _tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _update(cfg: AdamWConfig, grads: Tree, state: OptState, params: Tree,
            decay: Optional[Tree], in_place: bool,
            norm: Optional[torch.Tensor] = None):
    """One AdamW step, leaf by leaf: each gradient leaf is cast to float32
    and clipped as it is used, so no float32 copy of the whole gradient
    tree exists."""
    gn = global_norm(grads) if norm is None else norm
    scale = _clip_scale(gn, cfg.grad_clip) if cfg.grad_clip is not None \
        else None
    step = state.step + 1
    sf = step.float()
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None
                   else torch.ones((), device=sf.device))
    c1 = 1.0 - cfg.b1 ** sf
    c2 = 1.0 - cfg.b2 ** sf
    p_leaves = _leaves(params)
    decays = ([p.ndim >= 2 for p in p_leaves] if decay is None
              else _leaves(decay))
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, dec in zip(p_leaves, _leaves(grads), _leaves(state.m),
                               _leaves(state.v), decays):
        g = g.float()
        if scale is not None:
            g = g * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        if dec:                  # decoupled weight decay
            delta = delta + cfg.weight_decay * p.float()
        p2 = (p.float() - lr * delta).to(p.dtype)
        if in_place:
            p.copy_(p2)
            m.copy_(m2)
            v.copy_(v2)
        else:
            new_p.append(p2)
            new_m.append(m2)
            new_v.append(v2)
    metrics = {"grad_norm": gn, "lr": lr}
    if in_place:
        return params, OptState(step=step, m=state.m, v=state.v), metrics
    return (_rebuild(params, iter(new_p)),
            OptState(step=step, m=_rebuild(params, iter(new_m)),
                     v=_rebuild(params, iter(new_v))), metrics)


def adamw_update(cfg: AdamWConfig, grads: Tree, state: OptState,
                 params: Tree, *, decay: Optional[Tree] = None,
                 norm: Optional[torch.Tensor] = None):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``;
    metrics ``grad_norm`` (before clipping) and ``lr`` are 0-d tensors.
    ``decay``: a tree of bools shaped like ``params`` saying which leaves
    take weight decay (default: ``ndim >= 2``).  ``norm``: the gradient's
    global norm when ``grads`` is a slice of it (a rank of a mesh: the
    norm of the whole gradient, `global_norm` of the slice otherwise);
    clipping and the ``grad_norm`` metric use it."""
    return _update(cfg, grads, state, params, decay, in_place=False,
                   norm=norm)


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads: Tree, state: OptState,
                  params: Tree, *, decay: Optional[Tree] = None,
                  norm: Optional[torch.Tensor] = None):
    """`adamw_update` written into ``params`` and ``state``'s moments in
    place; returns ``(params, new_state, metrics)`` with the same
    parameter and moment tensors (the step counter is a new tensor)."""
    return _update(cfg, grads, state, params, decay, in_place=True,
                   norm=norm)


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
