"""The port's device mesh: named axes over a group of rank processes.

Port of `src/repro/launch/mesh.py`: `set_mesh` (:15),
`make_production_mesh` (:23) and `make_mesh` (:32).  The reference's
mesh is a grid of devices under one controller.  The port's `Mesh` is a
grid of ranks: `make_mesh` takes the pooled `RankGroup` of
``prod(shape)`` ranks (`repro_torch.distributed.ranks.shard_group`, so
the graph shards and the LM mesh share one group) and has every rank
build its `AxisGroups` (one process group per axis slice), kept in the
rank's ``state`` under the mesh's key.  Several meshes may lie over one
group (a re-mesh from ``(2, 2)`` to ``(1, 4)`` keeps the same four
ranks).  Rank ``r`` sits at ``np.unravel_index(r, shape)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.ranks import (AxisGroups, RankGroup,
                                           shard_group)

__all__ = ["Mesh", "current_mesh", "make_mesh", "make_production_mesh",
           "set_mesh"]


@dataclasses.dataclass(eq=False)
class Mesh:
    """``shape`` (a dict, axis -> ranks) over ``axis_names``, laid over
    the ranks of ``group``; ``key`` names the ranks' `AxisGroups`."""

    axis_names: tuple
    shape: dict
    group: RankGroup
    key: str

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def device_type(self) -> str:
        return self.group.device_type

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s index along each axis."""
        dims = tuple(self.shape[a] for a in self.axis_names)
        return {a: int(c) for a, c in zip(self.axis_names,
                                          np.unravel_index(rank, dims))}


def _r_make_axes(r, key: str, shape: tuple, axes: tuple) -> None:
    r.state[key] = AxisGroups(shape, axes, r.rank)


def make_mesh(shape: tuple, axes: tuple, *, device="cuda",
              dist_backend: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``prod(shape)`` ranks of the
    pooled group on ``device`` (``dist_backend`` as `shard_group`: NCCL
    needs a card a rank; gloo puts every rank on card 0)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up, "
                         f"axes distinct")
    if min(shape) < 1:
        raise ValueError(f"mesh shape {shape} has an empty axis")
    group = shard_group(int(np.prod(shape)), device=device,
                        dist_backend=dist_backend)
    key = group.new_key("mesh")
    group.run(_r_make_axes, None, key, shape, axes)
    return Mesh(axis_names=axes, shape=dict(zip(axes, shape)), group=group,
                key=key)


_CURRENT: list = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh (`current_mesh`) inside the block."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    return _CURRENT[-1] if _CURRENT else None


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         dist_backend: Optional[str] = None) -> Mesh:
    """Single pod: (16, 16) = 256 ranks, axes (data, model).  Multi-pod:
    (2, 16, 16) = 512 ranks, axes (pod, data, model) — the ``pod`` axis
    carries only data-parallel gradient traffic.  One card a rank:
    raises, naming what it needs, on a machine with fewer cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    have = (torch.cuda.device_count()
            if torch.device(device).type == "cuda"
            and torch.cuda.is_available() else 0)
    if have < need:
        raise ValueError(f"the production mesh {shape} over {axes} needs "
                         f"{need} ranks, one card each; this machine has "
                         f"{have} card(s)")
    return make_mesh(shape, axes, device=device,
                     dist_backend=dist_backend or "nccl")
