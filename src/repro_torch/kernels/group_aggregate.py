"""Group-based neighbor aggregation on Hopper: the wrapper of the CUDA kernels.

Port of `src/repro/kernels/group_aggregate.py:group_aggregate_pallas`
(the `pl.pallas_call` at :446 and its bodies `_kernel` :67 and
`_direct_kernel` :117).  Three gather variants compute one function,
``out[v] = sum over v's groups of sum_s ev * feat[nbr]``:

  * ``folded`` / ``slot_onehot`` — `csrc/group_aggregate_onehot.cu`: a
    dense product against the tile's feature window through a one-hot
    gather matrix (folded sums a group's slots inside the matrix; slot
    keeps one row per slot), staged in chunks through shared memory.
  * ``direct`` — `csrc/group_aggregate_gather.cu`: per-slot row gathers,
    warps over groups and lanes over the feature dimension (the paper's
    own GPU mapping).

Both kernels take one thread block per run of tiles sharing a node block
(the leader-node scheme: the block's shared-memory accumulator is zeroed
at the run's start and written to device memory once) and per column
slice.  Each source file states what bounds its kernel on the card and
what its design does about it.

Dispatch is by device and nothing else: a CUDA tensor launches the kernel
(or the call raises — there is no fallback), a CPU tensor runs the plain
PyTorch version `repro_torch.kernels.ref.group_aggregate_ref`.  Every
launch and every plain call adds one to its count in `launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from repro_torch.hw import H100_SXM
from repro_torch.kernels import build
from repro_torch.kernels.ref import group_aggregate_ref

__all__ = ["VARIANTS", "KERNEL_OF_VARIANT", "Geometry", "group_aggregate",
           "group_aggregate_plain", "launch_geometry", "launches",
           "reset_launches"]

# canonical order: default first (the tuner's base config uses it)
VARIANTS: tuple = ("folded", "slot_onehot", "direct")
KERNEL_OF_VARIANT = {"folded": "group_aggregate_onehot[folded]",
                     "slot_onehot": "group_aggregate_onehot[slot]",
                     "direct": "group_aggregate_gather"}
PLAIN = "group_aggregate_ref"

# launch counts: one per kernel launch, one per plain-version call
launches: Dict[str, int] = {k: 0 for k in (*KERNEL_OF_VARIANT.values(), PLAIN)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# one-hot kernel chunking (see csrc/group_aggregate_onehot.cu)
_ONEHOT_ROWS = 32              # window rows per chunk (ch)
_ONEHOT_COLS = 64              # most columns per block (dc)
_FOLDED_GROUPS = 32            # groups per chunk, folded
_SLOT_ROWS = 128               # W rows per chunk, slot_onehot (gc * gs)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown gather variant {variant!r}; "
                         f"expected one of {VARIANTS}")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch geometry of one kernel call: group chunk ``gc``, window-row
    chunk ``ch``, columns per block ``dc``, dynamic shared memory bytes."""

    gc: int
    ch: int
    dc: int
    smem_bytes: int


def launch_geometry(variant: str, *, gs: int, gpt: int, ont: int,
                    dt: int) -> Geometry:
    """What a launch at these knobs allocates — the single source of the
    shared-memory working set the tuner's Eq. 4 prices
    (`repro_torch.core.model.smem_working_set`)."""
    _check_variant(variant)
    if variant == "direct":
        return Geometry(gc=0, ch=0, dc=dt, smem_bytes=4 * ont * dt)
    dc = min(dt, _ONEHOT_COLS)
    ch = _ONEHOT_ROWS
    if variant == "folded":
        gc = min(gpt, _FOLDED_GROUPS)
        wrows = gc
    else:
        gc = max(1, min(gpt, _SLOT_ROWS // gs))
        wrows = gc * gs
    smem = 4 * (ont * dc + gc * dc + ch * dc + wrows * ch)
    return Geometry(gc=gc, ch=ch, dc=dc, smem_bytes=smem)


def group_aggregate_plain(feat_padded: torch.Tensor, nbrs: torch.Tensor,
                          edge_val: torch.Tensor, local_node: torch.Tensor,
                          tile_node_block: torch.Tensor, *, ont: int,
                          out_rows: int) -> torch.Tensor:
    """The plain PyTorch version on any device, counted in `launches`."""
    launches[PLAIN] += 1
    return group_aggregate_ref(feat_padded, nbrs, edge_val, local_node,
                               tile_node_block, ont, out_rows)


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, feat on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind(lib: ctypes.CDLL, fn_name: str):
    """The C entry point with its return type declared; every argument is
    passed as an explicit ctypes value (c_void_p pointers, c_int ints)."""
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    return fn


def _raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def group_aggregate(feat_padded: torch.Tensor, nbrs: torch.Tensor,
                    edge_val: torch.Tensor, local_node: torch.Tensor,
                    tile_node_block: torch.Tensor, tile_window: torch.Tensor,
                    run_start: torch.Tensor, *, gs: int, gpt: int, ont: int,
                    src_win: int, dt: int, out_rows: int,
                    variant: str = "folded") -> torch.Tensor:
    """Run group aggregation over a padded schedule.

    feat_padded : (N_src_pad, D_pad) float32 | bfloat16 | float16;
        N_src_pad % src_win == 0 and D_pad % dt == 0 (`kernels.ops.aggregate`
        pads).
    nbrs, edge_val : (T, gpt, gs) int32 / float (edge values are read as
        float32; a 16-bit edge-value tensor is up-cast exactly).
    local_node : (T, gpt) int32; tile_node_block / tile_window : (T,) int32.
    run_start : (R+1,) int32 tile bounds of the maximal runs of tiles
        sharing a node block (`kernels.ops.DeviceSchedule` builds it); each
        node block must form exactly one run.

    Returns (out_rows, D_pad) float32.  Rows of node blocks no tile names
    are undefined on the CUDA path (the caller masks them, as the
    reference does); the plain version writes zeros there.
    """
    _check_variant(variant)
    if not feat_padded.is_cuda:
        return group_aggregate_plain(feat_padded, nbrs, edge_val, local_node,
                                     tile_node_block, ont=ont,
                                     out_rows=out_rows)

    dev = feat_padded.device
    n_src, d_pad = feat_padded.shape
    if feat_padded.dtype not in _DTYPE_CODE:
        raise TypeError(f"feat dtype {feat_padded.dtype} not supported; "
                        f"one of {list(_DTYPE_CODE)}")
    if not feat_padded.is_contiguous():
        raise ValueError("feat_padded must be contiguous")
    if n_src % src_win or d_pad % dt or out_rows % ont:
        raise ValueError(f"padding mismatch: n_src={n_src} src_win={src_win} "
                         f"d_pad={d_pad} dt={dt} out_rows={out_rows} ont={ont}")
    T = nbrs.shape[0]
    if edge_val.dtype != torch.float32:
        edge_val = edge_val.float()
    _check("nbrs", nbrs, torch.int32, (T, gpt, gs), dev)
    _check("edge_val", edge_val, torch.float32, (T, gpt, gs), dev)
    _check("local_node", local_node, torch.int32, (T, gpt), dev)
    _check("tile_node_block", tile_node_block, torch.int32, (T,), dev)
    _check("tile_window", tile_window, torch.int32, (T,), dev)
    if run_start.dim() != 1 or run_start.numel() < 2:
        raise ValueError("run_start must be (R+1,) with R >= 1")
    _check("run_start", run_start, torch.int32, run_start.shape, dev)
    num_runs = run_start.numel() - 1

    geo = launch_geometry(variant, gs=gs, gpt=gpt, ont=ont, dt=dt)
    if geo.smem_bytes > H100_SXM.smem_per_block:
        raise ValueError(f"{variant} at gs={gs} gpt={gpt} ont={ont} dt={dt} "
                         f"needs {geo.smem_bytes} B of shared memory per "
                         f"block (> {H100_SXM.smem_per_block} B)")
    out = torch.empty((out_rows, d_pad), dtype=torch.float32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    i = ctypes.c_int
    dcode = _DTYPE_CODE[feat_padded.dtype]
    with torch.cuda.device(dev):
        if variant == "direct":
            lib = build.load("group_aggregate_gather")
            fn = _bind(lib, "repro_group_aggregate_gather")
            code = fn(i(dcode), ptr(feat_padded), ptr(nbrs), ptr(edge_val),
                      ptr(local_node), ptr(tile_node_block), ptr(run_start),
                      ptr(out), i(num_runs), i(gs), i(gpt), i(ont), i(d_pad),
                      i(dt), i(geo.smem_bytes), stream)
        else:
            lib = build.load("group_aggregate_onehot")
            fn = _bind(lib, "repro_group_aggregate_onehot")
            code = fn(i(int(variant == "folded")), i(dcode), ptr(feat_padded),
                      ptr(nbrs), ptr(edge_val), ptr(local_node),
                      ptr(tile_node_block), ptr(tile_window), ptr(run_start),
                      ptr(out), i(num_runs), i(gs), i(gpt), i(ont),
                      i(src_win), i(d_pad), i(geo.gc), i(geo.ch), i(geo.dc),
                      i(geo.smem_bytes), stream)
    _raise_on(lib, code, KERNEL_OF_VARIANT[variant])
    launches[KERNEL_OF_VARIANT[variant]] += 1
    return out
