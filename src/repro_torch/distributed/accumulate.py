"""Micro-batched gradient accumulation.

Port of `src/repro/distributed/accumulate.py` (`split_batch` :25,
`accumulate_gradients` :32), single-device: the reference's `lax.scan`
over micro-batches is a Python loop, each micro-batch's gradients come
from `torch.autograd.grad` and are summed in float32, and the loss and
metrics are averaged.  With one micro-batch the gradients keep the
parameters' dtypes, as the reference's `value_and_grad` gives them.

Shapes: every batch leaf is (n_micro * mb, ...) and is split into
n_micro slices of mb rows along the leading axis.

On a mesh, inside a rank (`accumulate_gradients_on_ranks`): micro-batch
``i`` is the global rows ``[i mb, (i+1) mb)``, as the reference's
reshape makes it, and the rank's micro-batch is its ``(pod, data)``
slice of those rows (`rank_micro_batches`), not the ``i``-th part of a
contiguous block of its own, so the MoE's statistics and capacity and
the mask count see the rows the reference's micro-batch holds.  Each
micro-batch's gradients end, inside the backward, in the FSDP
reduce-scatters over ``data`` (`repro_torch.distributed.sharding.relayout`);
after the last one, every leaf the specs do not split over a batch axis
is summed over it, in float32, one all-reduce per set of axes over the
leaves that share it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.runtime.checkpoint import _leaves, _rebuild

Tree = Any

__all__ = ["accumulate_gradients", "accumulate_gradients_on_ranks",
           "rank_micro_batches", "split_batch"]


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


def rank_micro_batches(batch: dict, n_micro: int, mesh, specs: dict) -> list:
    """Inside a rank (``mesh`` its `AxisGroups`): the whole ``batch``'s
    ``n_micro`` micro-batches, each as the rank's slice of it by
    ``specs`` (a `PartitionSpec` per key), paired with ``rep``: how many
    batch ranks hold the same rows (1 when the micro-batch splits over
    the batch axes, else their size: every batch rank then holds it
    whole, as the reference's constraint falls back)."""
    from repro_torch.distributed.sharding import (P, batch_axes_for,
                                                  constrain, valid_spec)
    out = []
    baxes = batch_axes_for(mesh)
    for mb in split_batch(batch, n_micro):
        rows = next(iter(mb.values())).shape[0]
        split = valid_spec(mesh, P(baxes), (rows,))[0] is not None
        out.append(({k: constrain(v, mesh, specs[k]) for k, v in mb.items()},
                    1 if split else mesh.size(baxes)))
    return out


def accumulate_gradients_on_ranks(loss_fn: Callable, params, batch: dict,
                                  n_micro: int, batch_specs: dict):
    """Inside a rank: `accumulate_gradients` over the rank's slice of the
    parameters.  ``params`` is the rank's
    `repro_torch.distributed.sharding.Local` slice; ``batch`` the whole
    batch on the rank's device; ``loss_fn(params_local, micro_batch,
    rep)`` returns (the rank's part of the micro-batch's loss, whole
    metrics), as `repro_torch.nn.tensor_parallel.lm_loss_tp` does.

    Returns (grads, loss, metrics): grads float32, shaped like
    ``params.tree``, the rank's slice of the whole gradient (the mean
    over micro-batches); loss and metrics the micro-batches' means."""
    from repro_torch.distributed.sharding import (Local, batch_axes_for,
                                                  split_axes, tree_flatten,
                                                  tree_leaves, tree_unflatten)
    mesh = params.mesh
    leaves, skeleton = tree_flatten(params.tree)
    specs = tree_leaves(params.specs)
    req = [p.detach().requires_grad_() for p in leaves]
    local = Local(tree_unflatten(skeleton, req), params.specs, mesh)
    acc, loss_acc, m_acc = None, 0.0, {}
    for mb, rep in rank_micro_batches(batch, n_micro, mesh, batch_specs):
        with torch.enable_grad():
            loss, metrics = loss_fn(local, mb, rep)
            grads = torch.autograd.grad(loss, req, allow_unused=True,
                                        materialize_grads=True)
        if acc is None:
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a += g.float()
        del grads, loss
        loss_acc = loss_acc + metrics["loss"].float()
        m_acc = {k: m_acc.get(k, 0.0) + v.float() for k, v in metrics.items()}
    # the sums over the batch axes a leaf is not split over: one
    # all-reduce of the concatenated leaves per set of axes
    groups: dict = {}
    for i, sp in enumerate(specs):
        split = split_axes(sp)
        axes = tuple(a for a in batch_axes_for(mesh)
                     if a not in split and mesh.size(a) > 1)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        flat = mesh.all_reduce(torch.cat([acc[i].reshape(-1) for i in idx]),
                               axes)
        for i, part in zip(idx, flat.split([acc[i].numel() for i in idx])):
            acc[i].copy_(part.view_as(acc[i]))
        del flat
    inv = 1.0 / n_micro
    return (tree_unflatten(skeleton, [a.mul_(inv) for a in acc]),
            loss_acc * inv, {k: v * inv for k, v in m_acc.items()})
