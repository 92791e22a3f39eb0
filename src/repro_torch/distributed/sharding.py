"""Sharding helpers: partition specs on the port's mesh, placements, and a
rank's view of its slice of a tree.

Port of `src/repro/distributed/sharding.py`: `batch_axes_for` (:20),
`batch_spec` (:25), `valid_spec` (:30), `prune_specs_for_mesh` (:49),
`named_shardings` (:57), `replicated` (:67) and `constrain` (:71), with
the same semantics.  A spec is a `repro_torch.nn.layers.PartitionSpec`;
a mesh is anything with ``axis_names`` and a ``shape`` dict (the
caller's `repro_torch.launch.mesh.Mesh`, a rank's
`repro_torch.distributed.ranks.AxisGroups`).  `NamedSharding` is a
placement: which slice of a leaf each rank of the mesh holds.  The
reference's `constrain` is a compiler hint; here it is where a rank
takes its slice of an activation (it runs inside a rank).

Port-only: the tree helpers over the port's nested dicts, lists and
tuples (a `PartitionSpec` is a leaf, ``None`` an empty subtree), and
`Local`, a rank's slice of a tree with the specs it is laid out by,
whose `Local.get` brings a leaf into the layout a layer computes in (an
all-gather over the axes it is split over and not wanted, a local slice
along the axes wanted and not split over).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.nn.layers import PartitionSpec

__all__ = ["Local", "NamedSharding", "batch_axes_for", "batch_spec",
           "constrain", "join_batch", "named_shardings", "prune_specs_for_mesh",
           "relayout", "replicated", "shard_index", "split_axes",
           "tree_flatten",
           "tree_leaves", "tree_map", "tree_unflatten", "valid_spec"]

P = PartitionSpec


# ---------------------------------------------------------------------------
# trees: nested dicts / lists / tuples; a PartitionSpec is a leaf, None is
# an empty subtree

def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(x, P)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``),
    keeping the structure; ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        children = [tree_map(fn, v, *(r[i] for r in rest))
                    for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):            # a NamedTuple (OptState)
            return type(tree)(*children)
        return type(tree)(children)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_flatten(tree) -> tuple:
    """``(leaves, skeleton)``: the skeleton is the tree with each leaf
    replaced by its index (picklable without the leaves)."""
    leaves = []

    def take(x):
        leaves.append(x)
        return len(leaves) - 1

    return leaves, tree_map(take, tree)


def tree_unflatten(skeleton, leaves: list):
    return tree_map(lambda i: leaves[i], skeleton)


# ---------------------------------------------------------------------------
# specs on a mesh

def batch_axes_for(mesh) -> tuple:
    """Mesh axes that carry data parallelism (pod is pure DP)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, extra_dims: int = 1) -> P:
    """(batch, ...) activations: batch over (pod, data)."""
    return P(batch_axes_for(mesh), *([None] * extra_dims))


def _axes(entry) -> tuple:
    return entry if isinstance(entry, (tuple, list)) else (entry,)


def split_axes(spec) -> tuple:
    """The mesh axes ``spec`` splits a leaf over, in its order."""
    return tuple(a for e in spec for a in _axes(e) if a is not None)


def valid_spec(mesh, spec, shape: tuple) -> P:
    """Drop spec entries whose mesh axis doesn't exist or doesn't divide
    the dim (kv-head counts smaller than the model axis fall back to
    replication); one entry per dim."""
    out = []
    for i, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = tuple(a for a in _axes(ax)
                     if a is not None and a in mesh.axis_names)
        size = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if not axes or shape[i] % size != 0:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def prune_specs_for_mesh(mesh, specs, shapes):
    """Apply `valid_spec` leaf-wise (``shapes``: a tree of anything with
    ``.shape``, or of shapes)."""
    return tree_map(lambda sp, x: valid_spec(
        mesh, sp, tuple(getattr(x, "shape", x))), specs, shapes)


def shard_index(mesh, spec, shape: tuple, coords: dict) -> tuple:
    """The slices of a ``shape`` leaf that the rank at ``coords`` holds
    under ``spec``: a dim split over axes ``(a, b)`` is cut into
    ``|a| |b|`` equal blocks, block ``coords[a] |b| + coords[b]``."""
    idx = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        axes = tuple(a for a in _axes(ax) if a is not None)
        if not axes:
            idx.append(slice(None))
            continue
        sizes = [mesh.shape[a] for a in axes]
        c = n // int(np.prod(sizes))
        k = int(np.ravel_multi_index([coords[a] for a in axes], sizes))
        idx.append(slice(k * c, (k + 1) * c))
    return tuple(idx)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` on ``mesh`` (the counterpart of
    `jax.sharding.NamedSharding`)."""

    mesh: Any
    spec: P


def named_shardings(mesh, specs, shapes: Optional[Any] = None):
    """PartitionSpec tree -> NamedSharding tree (optionally validated
    against ``shapes``)."""
    if shapes is not None:
        specs = prune_specs_for_mesh(mesh, specs, shapes)
    return tree_map(lambda sp: NamedSharding(mesh, sp), specs)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def constrain(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """Inside a rank: this rank's slice of the whole activation ``x``
    under ``spec`` (validated against ``x``'s shape); ``mesh`` is the
    rank's `AxisGroups`."""
    sp = valid_spec(mesh, spec, tuple(x.shape))
    return x[shard_index(mesh, sp, tuple(x.shape), mesh.coords)]


def join_batch(mesh, batch_axes, parts: list, batch: int) -> torch.Tensor:
    """The whole batch (dim 0 of size ``batch``) from the ranks' batch
    slices (``parts`` in rank order, None where a rank sent none), split
    over ``batch_axes``: the first slice of each batch index, in their
    order; a batch the axes do not divide is whole on every rank."""
    baxes = tuple(a for a in batch_axes if a in mesh.axis_names)
    split = valid_spec(mesh, P(baxes), (batch,))[0]
    axes = _axes(split) if split is not None else ()
    first = {}
    for rank, part in enumerate(parts):
        if part is not None:
            c = mesh.coords(rank)
            first.setdefault(tuple(c[a] for a in axes), part)
    return torch.cat([first[k] for k in sorted(first)], dim=0)


# ---------------------------------------------------------------------------
# inside a rank: a slice of a tree and its layouts

def _present(mesh, entry) -> tuple:
    return tuple(a for a in _axes(entry) if a is not None and a in mesh.shape)


def relayout(x: torch.Tensor, have, want, mesh) -> torch.Tensor:
    """Inside a rank: ``x``, this rank's slice of a leaf laid out by
    ``have``, as its slice under ``want`` (all-gathers over the axes a
    dim is split over and not wanted; a local slice along the axes it is
    wanted over).  Raises when a wanted split does not divide its dim.

    Under autograd (`repro_torch.distributed.ranks`' convention): the
    gather's backward sums over the batch axes among those gathered (the
    FSDP reduce-scatter over ``data``) and takes the slice along the
    others; the local slice of a leaf held whole along ``w`` is read by
    each rank of ``w`` in part, so its gradient is summed over ``w``
    (`copy_to`) before the slice is taken."""
    from repro_torch.distributed.ranks import copy_to, gather_from
    batch = batch_axes_for(mesh)
    for d in range(x.dim()):
        h = _present(mesh, have[d] if d < len(have) else None)
        w = _present(mesh, want[d] if d < len(want) else None)
        if h == w:
            continue
        if h:
            x = gather_from(x, mesh, h, d, sum_grad=tuple(
                a for a in h if a in batch))
        if w:
            x = mesh.chunk(copy_to(x, mesh, w), w, d)
    return x


class Local:
    """Inside a rank: its slice of a tree (parameters or a cache), the
    pruned specs it is laid out by, and the rank's mesh.  Indexing gives
    the subtree; `get` a leaf in the layout a layer computes in."""

    def __init__(self, tree, specs, mesh):
        self.tree, self.specs, self.mesh = tree, specs, mesh

    def __getitem__(self, key) -> "Local":
        return Local(self.tree[key], self.specs[key], self.mesh)

    def __len__(self) -> int:
        return len(self.tree)

    def __iter__(self):
        return (self[i] for i in range(len(self.tree)))

    def get(self, key, *want) -> torch.Tensor:
        """Leaf ``key`` split over the axes ``want`` names per dim (None:
        whole; missing trailing entries: whole)."""
        return relayout(self.tree[key], self.specs[key], want, self.mesh)

    def full(self) -> dict:
        """Every leaf of this dict whole (norm gains and the like)."""
        return {k: self.get(k) for k in self.tree}
