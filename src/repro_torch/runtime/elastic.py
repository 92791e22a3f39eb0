"""Elastic re-meshing: lay a tree out on a mesh's ranks, bring it back,
and move it onto another mesh.

Port of `src/repro/runtime/elastic.py`: `MeshPlan` (:26), `plan_mesh`
(:39), `reshard` (:52) and `remesh_state` (:60).  The reference's
`reshard` is a `device_put` per leaf; here it sends each rank of the
mesh its slice of each leaf (under the leaf's spec, pruned by
`valid_spec`) and the rank keeps it in its ``state``: the result is a
`ShardedTree`, a handle to the tree on the ranks, which the LM mesh
steps take in place of a whole tree.  `gather` brings a tree back whole.
A CUDA leaf reaches the ranks by CUDA IPC (each rank copies its slice
out of the caller's memory); a CPU leaf as a numpy array (a file past
1 MB, `repro_torch.distributed.ranks`).

`remesh_state` goes through host memory, the reference's fallback
(exactly what a restart after a failure does through
`runtime.checkpoint`).  It moves serving state (parameters, a decode
cache) and training state alike: live parameters and their
`repro_torch.optim.adamw.OptState` (moments laid out like the
parameters, `repro_torch.models.lm.opt_state_specs`) move from one mesh
to another and the sharded train step continues there.  The global
batch stays fixed, so the optimizer's trajectory does not move across a
re-mesh: the losses after it are the un-re-meshed run's, up to float32
rounding of another layout.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Optional

import torch

from repro_torch.distributed.ranks import from_wire, to_wire
from repro_torch.distributed.sharding import (Local, prune_specs_for_mesh,
                                              shard_index, tree_flatten,
                                              tree_leaves, tree_map,
                                              tree_unflatten)
from repro_torch.launch.mesh import Mesh, make_mesh

__all__ = ["MeshPlan", "ShardedTree", "gather", "plan_mesh",
           "remesh_state", "reshard"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple

    def build(self, *, device="cuda",
              dist_backend: Optional[str] = None) -> Mesh:
        """The mesh on ``prod(shape)`` ranks (`make_mesh`)."""
        return make_mesh(self.shape, self.axes, device=device,
                         dist_backend=dist_backend)


def plan_mesh(num_devices: int, *, model_parallel: int = 1,
              pods: int = 1) -> MeshPlan:
    """Pick a (pod, data, model) factorization for an arbitrary device
    count — the elastic-rescale entry point (e.g. 512 -> 384 after
    losing a pod slice).  Raises `ValueError` when ``pods *
    model_parallel`` does not divide ``num_devices`` (the reference
    asserts it)."""
    if num_devices % (pods * model_parallel):
        raise ValueError(f"{num_devices} devices do not split into {pods} "
                         f"pod(s) x data x {model_parallel} model ranks")
    data = num_devices // (pods * model_parallel)
    if pods > 1:
        return MeshPlan((pods, data, model_parallel), ("pod", "data", "model"))
    return MeshPlan((data, model_parallel), ("data", "model"))


@dataclasses.dataclass(eq=False)
class ShardedTree:
    """A tree laid out on ``mesh``'s ranks: each rank holds its slice of
    every leaf under ``key``, laid out by ``specs`` (pruned).
    ``skeleton`` is the tree with each leaf's index in its place;
    ``shapes`` and ``dtypes`` list the whole leaves' in that order;
    ``nbytes`` counts the bytes sent to the ranks.  The ranks free it
    when the handle is dropped (with the group's next call) or at
    `drop`."""

    mesh: Mesh
    key: str
    skeleton: Any
    specs: Any
    shapes: list
    dtypes: list
    nbytes: int = 0

    def __post_init__(self):
        self._release = weakref.finalize(self, self.mesh.group.release,
                                         self.key)

    def drop(self) -> None:
        """Free the ranks' slices now."""
        if self._release.detach() is not None:
            self.mesh.group.drop(self.key)


def _own(x, device: torch.device) -> torch.Tensor:
    """A received leaf as this rank's own tensor on ``device``: an IPC
    tensor is copied out of the sender's memory."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
    return from_wire(x, device)


def _r_put(r, key: str, mesh_key: str, skeleton, specs, leaves: list):
    tree = tree_unflatten(skeleton, [_own(x, r.device) for x in leaves])
    del leaves
    r.state[key] = Local(tree, specs, r.state[mesh_key])


def _r_get(r, key: str) -> list:
    return [to_wire(t) for t in tree_leaves(r.state[key].tree)]


def reshard(tree, mesh: Mesh, specs) -> ShardedTree:
    """Lay ``tree`` (tensors) out on ``mesh``'s ranks by ``specs`` (a
    tree of `PartitionSpec`, pruned here against the leaves' shapes).
    Returns the handle; ``tree`` is left as it is."""
    # the specs in the tree's own key order (the two may list keys apart)
    specs = tree_map(lambda _, sp: sp, tree,
                     prune_specs_for_mesh(mesh, specs, tree))
    leaves, skeleton = tree_flatten(tree)
    spec_leaves = tree_leaves(specs)
    ipc = mesh.device_type == "cuda"
    per_rank, nbytes = [], 0
    for rank in range(mesh.size):
        coords = mesh.coords(rank)
        mine = []
        for t, sp in zip(leaves, spec_leaves):
            part = t.detach()[shard_index(mesh, sp, tuple(t.shape), coords)]
            nbytes += part.numel() * part.element_size()
            mine.append(part if ipc and part.is_cuda else to_wire(part))
        per_rank.append((mine,))
    key = mesh.group.new_key("tree")
    mesh.group.run(_r_put, per_rank, key, mesh.key, skeleton, specs)
    del per_rank
    if ipc:
        torch.cuda.ipc_collect()
    return ShardedTree(
        mesh=mesh, key=key, skeleton=skeleton, specs=specs,
        shapes=[tuple(t.shape) for t in leaves],
        dtypes=[t.dtype for t in leaves], nbytes=nbytes)


def gather(handle: ShardedTree, device="cpu"):
    """The tree ``handle`` points to, whole, on ``device``."""
    mesh = handle.mesh
    parts = mesh.group.run(_r_get, None, handle.key)
    out = []
    for i, (shape, dtype, sp) in enumerate(zip(
            handle.shapes, handle.dtypes, tree_leaves(handle.specs))):
        whole = torch.empty(shape, dtype=dtype, device=device)
        for rank in range(mesh.size):
            whole[shard_index(mesh, sp, shape, mesh.coords(rank))] = \
                from_wire(parts[rank][i], device)
        out.append(whole)
    return tree_unflatten(handle.skeleton, out)


def remesh_state(state, specs, new_mesh: Mesh) -> ShardedTree:
    """Move ``state`` (a `ShardedTree` or a tree of tensors: parameters,
    an `OptState` by `opt_state_specs`, a cache) onto ``new_mesh`` by the
    same logical ``specs``, through host memory."""
    host = (gather(state) if isinstance(state, ShardedTree)
            else tree_map(lambda t: t.detach().cpu(), state))
    return reshard(host, new_mesh, specs)
