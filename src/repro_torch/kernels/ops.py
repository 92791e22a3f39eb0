"""Public aggregation entry point over a group schedule.

Port of `src/repro/kernels/ops.py` (forward only: serving needs no
gradient; the `torch.autograd.Function` with the transposed-schedule
backward comes with the training slice).

`aggregate(...)` takes raw node features plus a `DeviceSchedule`, handles
all padding, and dispatches to the hand-written CUDA kernels or to the
plain PyTorch version.

Backend dispatch rules
----------------------
  * ``"cuda"`` — the Hopper kernels in `repro_torch.kernels.group_aggregate`
    (the counterpart of the reference's ``"pallas"``).  The default.  Needs
    CUDA tensors: a CPU tensor raises, there is no silent fallback.
  * ``"torch"`` — `repro_torch.kernels.ref.group_aggregate_ref`, plain
    PyTorch gather + index-add on whatever device the tensors are on (the
    counterpart of the reference's ``"xla"``): the semantic ground truth.

Dtype rules (unchanged from the reference)
-----------------------------------------
``feat`` may be float32, bfloat16 or float16; it is the dtype the kernel
loads, so bf16 halves the feature bytes.  Accumulation is ALWAYS float32.
``out_dtype`` is the dtype of the RESULT, applied as the final cast (None
= float32).  Static edge values are float32; dynamic edge values keep
their own float dtype through `_scatter_edge_values` and are read as
float32 by the kernels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.group_aggregate import (group_aggregate,
                                                 group_aggregate_plain)

__all__ = ["BACKENDS", "aggregate", "DeviceSchedule", "dim_tile",
           "run_bounds"]

BACKENDS = ("cuda", "torch")


def dim_tile(dt: int, d: int, dtype) -> int:
    """Effective dim-tile width for a D-wide feature operand.

    The kernel pads D up to a multiple of the tile, so the tile must divide
    an aligned padded width: round D up to the dtype's alignment unit (8
    elements for 32-bit, 16 for 16-bit: one 32-byte memory sector either
    way) BEFORE clamping ``dt`` to it.  Same rule as the reference, so both
    packages pad every width alike.
    """
    if not isinstance(dtype, torch.dtype):       # a name or a numpy dtype
        dtype = getattr(torch, dtype if isinstance(dtype, str)
                        else np.dtype(dtype).name)
    try:
        from repro_torch.core.model import feat_dtype_align
        unit = feat_dtype_align(str(dtype).removeprefix("torch."))
    except ValueError:
        # outside the policy vocabulary (float64): 8 for 32-bit and wider
        unit = max(8, 8 * 4 // max(dtype.itemsize, 1))
    dt_aligned = -(-max(dt, 1) // unit) * unit
    d_aligned = -(-max(d, 1) // unit) * unit
    return min(dt_aligned, max(unit, d_aligned))


def run_bounds(tile_node_block: np.ndarray) -> np.ndarray:
    """(R+1,) int32 tile bounds of the maximal runs of consecutive tiles
    that share a node block.  Raises if one node block forms two runs: the
    kernels give each run its own thread block, and two blocks writing one
    node block would race (the partitioner sorts tiles block-major and
    `pad_partition_tiles` appends copies of the last block, so its
    schedules always pass)."""
    nb = np.asarray(tile_node_block)
    T = len(nb)
    if T == 0:
        return np.zeros(1, np.int32)
    change = np.ones(T, dtype=bool)
    change[1:] = nb[1:] != nb[:-1]
    starts = np.flatnonzero(change)
    if len(np.unique(nb[starts])) != len(starts):
        raise ValueError("schedule visits a node block in more than one run "
                         "of consecutive tiles")
    return np.append(starts, T).astype(np.int32)


class DeviceSchedule:
    """Device-resident copy of a GroupPartition's arrays + static config.

    Array members (T = tiles): ``nbrs``/``edge_val`` (T, gpt, gs),
    ``local_node`` (T, gpt), ``tile_node_block``/``tile_window`` (T,),
    ``run_start`` (R+1,) — the run boundaries the kernels launch one block
    per run over, built once here on the host over the ``live_tiles``
    prefix (trailing pad tiles hold no edge) —, ``block_visited``
    (padded_out_rows/ont,) bool, the unvisited-output-block mask, and
    ``edge_slot``/``edge_pos`` (E,).  Static ints mirror the partition's
    config (`gs`, `gpt`, `ont`, `src_win`) and padding geometry.

    Construction validates what the kernels index with (ids inside their
    tile's window, local rows inside the node block), so a malformed
    schedule raises here instead of reading out of bounds on the card.
    """

    def __init__(self, p, device="cpu"):
        T = p.num_tiles
        if T:
            nbrs = np.asarray(p.nbrs)
            win = np.asarray(p.tile_window).astype(np.int64)[:, None, None]
            if not ((nbrs // p.src_win) == win).all():
                raise ValueError("schedule has neighbor ids outside their "
                                 "tile's feature window")
            if (nbrs.min() < 0 or nbrs.max() >= p.padded_src_rows
                    or p.local_node.min() < 0 or p.local_node.max() >= p.ont
                    or p.tile_node_block.min() < 0
                    or p.tile_node_block.max() >= p.padded_out_rows // p.ont):
                raise ValueError("schedule indices out of range")
        as_t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a),
                                                  dtype=dt, device=device)
        self.nbrs = as_t(p.nbrs, torch.int32)
        self.device = self.nbrs.device        # concrete ("cuda:0", not "cuda")
        self.edge_val = as_t(p.edge_val, torch.float32)
        self.local_node = as_t(p.local_node, torch.int32)
        self.tile_node_block = as_t(p.tile_node_block, torch.int32)
        self.tile_window = as_t(p.tile_window, torch.int32)
        # tiles past the last one holding an edge slot are shape-bucketing
        # pad (`pad_partition_tiles` appends them, all on the LAST node
        # block): they add exactly zero for static and dynamic edge values
        # alike, so the runs the kernels launch stop at the live prefix —
        # otherwise one thread block would walk every pad tile serially
        self.live_tiles = (int(p.edge_slot.max()) // p.gpt + 1
                           if p.num_edges else 0)
        self.run_start = as_t(run_bounds(p.tile_node_block[:self.live_tiles]),
                              torch.int32)
        visited = p.block_visited()
        self.all_visited = bool(visited.all())
        self.block_visited = as_t(visited)
        self.edge_slot = as_t(p.edge_slot, torch.int64)
        self.edge_pos = as_t(p.edge_pos, torch.int64)
        self.gs, self.gpt, self.ont, self.src_win = p.gs, p.gpt, p.ont, p.src_win
        self.num_nodes = p.num_nodes
        self.num_edges = p.num_edges
        self.padded_src_rows = p.padded_src_rows
        self.padded_out_rows = p.padded_out_rows
        self.num_tiles = T
        self.num_runs = int(self.run_start.numel()) - 1


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = x.shape
    if r == rows and c == cols:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, cols - c, 0, rows - r))


def _scatter_edge_values(sched: DeviceSchedule,
                         edge_values: torch.Tensor) -> torch.Tensor:
    """Lay per-edge values (original CSR order) out in schedule layout,
    keeping their own float dtype (padded slots are 0)."""
    T, gpt, gs = sched.edge_val.shape
    ev_dtype = (edge_values.dtype if edge_values.is_floating_point()
                else torch.float32)
    out = torch.zeros((T * gpt, gs), dtype=ev_dtype, device=edge_values.device)
    out[sched.edge_slot, sched.edge_pos] = edge_values.to(ev_dtype)
    return out.reshape(T, gpt, gs)


def _visited_rows(sched: DeviceSchedule) -> torch.Tensor:
    """(padded_out_rows,) bool row mask from the block-visited mask."""
    return torch.repeat_interleave(sched.block_visited, sched.ont)


def aggregate(feat: torch.Tensor, sched: DeviceSchedule, *,
              dt: int = 128, backend: str = "cuda",
              variant: str = "folded",
              edge_values: Optional[torch.Tensor] = None,
              out_dtype=None) -> torch.Tensor:
    """out[v] = sum over v's neighbor groups of edge_val * feat[nbr].

    feat: (N, D) node features in the schedule's node order, on the
    schedule's device.  Returns (num_nodes, D) in ``out_dtype`` (None =
    float32).

    variant: "folded" | "slot_onehot" | "direct" — which CUDA kernel runs
    (see `repro_torch.kernels.group_aggregate`); the plain version ignores
    it (one lowering).

    edge_values: optional (E,) per-edge weights in ORIGINAL CSR edge order,
    overriding the schedule's static values (GAT's dynamic weights).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    n, d = feat.shape
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if n != sched.num_nodes:
        raise ValueError(f"feat has {n} rows, schedule {sched.num_nodes}")
    if feat.device != sched.device:
        raise ValueError(f"feat is on {feat.device}, schedule on "
                         f"{sched.device}")
    if backend == "cuda" and not feat.is_cuda:
        raise ValueError("backend='cuda' runs the CUDA kernels and needs CUDA "
                         "tensors; use backend='torch' on the CPU")
    if sched.num_tiles == 0 or (backend == "cuda" and sched.num_runs == 0):
        return torch.zeros((n, d), dtype=out_dtype, device=feat.device)
    ev = (sched.edge_val if edge_values is None
          else _scatter_edge_values(sched, edge_values))
    if backend == "torch":
        out = group_aggregate_plain(
            _pad_to(feat, sched.padded_src_rows, d), sched.nbrs, ev,
            sched.local_node, sched.tile_node_block, ont=sched.ont,
            out_rows=sched.padded_out_rows)
        return out[:n].to(out_dtype)
    dt_eff = dim_tile(dt, d, feat.dtype)
    d_pad = -(-d // dt_eff) * dt_eff
    out = group_aggregate(
        _pad_to(feat, sched.padded_src_rows, d_pad), sched.nbrs, ev,
        sched.local_node, sched.tile_node_block, sched.tile_window,
        sched.run_start, gs=sched.gs, gpt=sched.gpt, ont=sched.ont,
        src_win=sched.src_win, dt=dt_eff, out_rows=sched.padded_out_rows,
        variant=variant)[:n, :d]
    # node blocks no tile names are never written by the kernel (leader-node
    # flush); mask them to true zeros, as the reference does
    if not sched.all_visited:
        out = torch.where(_visited_rows(sched)[:n, None], out,
                          out.new_zeros(()))
    return out.to(out_dtype)
