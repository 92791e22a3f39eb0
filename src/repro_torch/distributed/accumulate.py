"""Micro-batched gradient accumulation.

Port of `src/repro/distributed/accumulate.py` (`split_batch` :25,
`accumulate_gradients` :32), single-device: the reference's `lax.scan`
over micro-batches is a Python loop, each micro-batch's gradients come
from `torch.autograd.grad` and are summed in float32, and the loss and
metrics are averaged.  With one micro-batch the gradients keep the
parameters' dtypes, as the reference's `value_and_grad` gives them.

Shapes: every batch leaf is (n_micro * mb, ...) and is split into
n_micro slices of mb rows along the leading axis.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.runtime.checkpoint import _leaves, _rebuild

Tree = Any

__all__ = ["accumulate_gradients", "split_batch"]


def split_batch(batch: dict, n_micro: int) -> list:
    """A dict of (n_micro * mb, ...) leaves -> n_micro dicts of (mb, ...)
    views."""
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does "
                             f"not split into {n_micro} micro-batches")
    return [{k: x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n_micro)]


def _grads(loss_fn: Callable, params: Tree, batch: dict):
    """(loss, metrics, grads): grads a list in `_leaves` order, zeros for
    a leaf the loss does not reach."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(_rebuild(params, iter(leaves)), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def accumulate_gradients(loss_fn: Callable, params: Tree, batch: dict,
                         n_micro: int):
    """loss_fn(params, microbatch) -> (loss, metrics) over the parameter
    tree ``params`` (dicts, tuples, lists of tensors).

    Returns (grads, loss, metrics): grads a tree shaped like ``params``
    (the mean over micro-batches, float32 when ``n_micro > 1``), loss
    and metrics their means."""
    if n_micro == 1:
        loss, metrics, grads = _grads(loss_fn, params, batch)
        return _rebuild(params, iter(grads)), loss, metrics
    acc, loss_acc, m_acc = None, 0.0, {}
    for mb in split_batch(batch, n_micro):
        loss, metrics, grads = _grads(loss_fn, params, mb)
        if acc is None:
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a += g.float()
        del grads
        loss_acc = loss_acc + loss.float()
        m_acc = {k: m_acc.get(k, 0.0) + v.float() for k, v in metrics.items()}
    inv = 1.0 / n_micro
    return (_rebuild(params, iter(a.mul_(inv) for a in acc)), loss_acc * inv,
            {k: v * inv for k, v in m_acc.items()})
