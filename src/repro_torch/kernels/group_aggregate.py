"""Group-based neighbor aggregation on Hopper: the wrapper of the CUDA kernels.

Port of `src/repro/kernels/group_aggregate.py:group_aggregate_pallas`
(the `pl.pallas_call` at :446 and its bodies `_kernel` :67 and
`_direct_kernel` :117).  Three gather variants compute one function,
``out[v] = sum over v's groups of sum_s ev * feat[nbr]``:

  * ``folded`` / ``slot_onehot`` — `csrc/group_aggregate_onehot.cu`: a
    walk over the live slots only (folded first sums a group's slots that
    name the same source row; slot multiplies per slot).  The run's tiles
    are split across the block's warps, each with a private partial in
    shared memory; each warp streams its share of the run's slot metadata
    in with TMA 1-D copies.
  * ``direct`` — `csrc/group_aggregate_gather.cu`: the same walk over the
    live slots with per-slot row gathers: the block's warps split the run
    in 32-slot chunks, list its live slots and gather their rows, lanes
    over a column slice of up to 128 columns (four a lane: one 16-byte load
    of float32), several rows in flight a lane, into per-warp partials;
    the runs launch longest first (`run_order`).

Both kernels take one thread block per run of tiles sharing a node block
(the leader-node scheme: the block's partials are zeroed at the run's
start, summed in a fixed order at its end and the node block is written to
device memory once) and per column slice.  Each source file states what
bounds its kernel on the card and what its design does about it.

The edge-value cotangent, `group_edge_grad` (port of
`group_edge_grad_pallas` :289, `pl.pallas_call` at :351), computes per
slot ``<grad[row(t,g)], feat[nbrs[t,g,s]]>`` in `csrc/group_edge_grad.cu`: all
three variants run the block kernel, which computes the real slots only,
taken from the schedule's per-edge slot index (a lane group per edge), so
it runs on any layout and group size.  It replaces both TPU bodies,
`_edge_grad_kernel` :183 (``folded`` / ``slot_onehot``) and
`_direct_edge_grad_kernel` :224 (``direct``).

Dispatch is by device and nothing else: a CUDA tensor launches the kernel
(or the call raises — there is no fallback), a CPU tensor runs the plain
PyTorch version (`repro_torch.kernels.ref.group_aggregate_ref` /
`group_edge_grad_ref`).  Every launch and every plain call adds one to its
count in `launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict

import torch

from repro_torch.hw import H100_SXM
from repro_torch.kernels import build
from repro_torch.kernels.build import bind, check_arg, raise_on
from repro_torch.kernels.ref import group_aggregate_ref, group_edge_grad_ref

__all__ = ["VARIANTS", "KERNEL_OF_VARIANT", "EDGE_GRAD_KERNEL",
           "EDGE_GRAD_KERNEL_OF_VARIANT",
           "Geometry", "group_aggregate", "group_aggregate_plain",
           "group_edge_grad", "group_edge_grad_plain", "launch_geometry",
           "launches", "reset_launches"]

# canonical order: default first (the tuner's base config uses it)
VARIANTS: tuple = ("folded", "slot_onehot", "direct")
KERNEL_OF_VARIANT = {"folded": "group_aggregate_onehot[folded]",
                     "slot_onehot": "group_aggregate_onehot[slot]",
                     "direct": "group_aggregate_gather"}
PLAIN = "group_aggregate_ref"
# the edge-value cotangent has no folded form, and the block kernel reads
# only the real edges' slots, so every variant's schedule runs it (the TPU
# has `_edge_grad_kernel` and `_direct_edge_grad_kernel`)
EDGE_GRAD_KERNEL = "group_edge_grad[block]"
EDGE_GRAD_KERNEL_OF_VARIANT = {v: EDGE_GRAD_KERNEL for v in VARIANTS}
EDGE_GRAD_PLAIN = "group_edge_grad_ref"

# launch counts: one per kernel launch, one per plain-version call
launches: Dict[str, int] = {
    k: 0 for k in (*KERNEL_OF_VARIANT.values(), PLAIN, EDGE_GRAD_KERNEL,
                   EDGE_GRAD_PLAIN)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# one-hot kernel launch (see csrc/group_aggregate_onehot.cu, `Layout`)
_ONEHOT_COLS = 64              # most columns per block (dc)
_ONEHOT_WARPS = 8              # warps per block (kWarps; no other count)
_ONEHOT_STAGE_UNITS = 4        # least units of whole groups per metadata stage
_ONEHOT_STAGES = 2             # metadata ring depth per warp (kStages)
_ONEHOT_LIST = 128             # live-slot list entries per warp (kListCap)
# the group chunk KernelModel's one-hot term prices (the earlier
# dense-window design)
_FOLDED_GROUPS = 32            # groups per chunk, folded
_SLOT_ROWS = 128               # W rows per chunk, slot_onehot (gc * gs)
_GATHER_WARPS = 8              # warps per block, direct (kWarps)
_GATHER_COLS = 4               # neighbouring columns a lane loads (kCols)
_GATHER_LIST = 128             # live-slot list entries per warp (kListCap)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown gather variant {variant!r}; "
                         f"expected one of {VARIANTS}")


def _check_aligned(**tensors: torch.Tensor) -> None:
    """The kernels read these with 16-byte loads or copies."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch geometry of one kernel call: columns per block ``dc``, warps
    per block and dynamic shared memory bytes; for the one-hot kernels also
    ``stage_units`` per metadata stage (0 for ``direct``).
    ``gc`` is the group chunk of the earlier dense-window design, which
    `core.model.KernelModel` still prices; no kernel reads it."""

    gc: int
    dc: int
    warps: int
    stage_units: int
    smem_bytes: int


def _onehot_smem(gs: int, ont: int, dc: int, warps: int,
                 stage_units: int) -> int:
    """Bytes of the one-hot kernel's `Layout`: each warp's mbarriers and
    metadata stages (ids, values, group rows), one ont x dc f32 partial
    per warp and slot lane group, and each warp's live-slot list."""
    align16 = lambda b: -(-b // 16) * 16
    unit = (32 // gs) * gs if gs <= 32 else gs
    slots = stage_units * unit
    lanes = 32 if dc > 32 else 16 if dc > 16 else 8
    stage = 8 * slots + align16(4 * (slots // gs))
    return (align16(8 * _ONEHOT_STAGES * warps)
            + warps * _ONEHOT_STAGES * stage
            + 4 * warps * (32 // lanes) * ont * dc + 12 * warps * _ONEHOT_LIST)


def _gather_smem(ont: int, dc: int) -> int:
    """Bytes of the direct kernel's `Layout`: one ont x dc f32 partial per
    warp and lane group (lanes per entry: the slice row's pieces of
    _GATHER_COLS columns, to a power of two), and each warp's live-slot
    list."""
    lanes = 1
    while lanes * _GATHER_COLS < dc:
        lanes *= 2
    return (4 * _GATHER_WARPS * (32 // lanes) * ont * dc
            + 12 * _GATHER_WARPS * _GATHER_LIST)


def launch_geometry(variant: str, *, gs: int, gpt: int, ont: int,
                    dt: int) -> Geometry:
    """What a launch at these knobs allocates — the single source of the
    shared-memory working set the tuner's Eq. 4 prices
    (`repro_torch.core.model.smem_working_set`)."""
    _check_variant(variant)
    if variant == "direct":
        dc = min(dt, 32 * _GATHER_COLS)
        return Geometry(gc=0, dc=dc, warps=_GATHER_WARPS, stage_units=0,
                        smem_bytes=_gather_smem(ont, dc))
    dc = min(dt, _ONEHOT_COLS)
    if variant == "folded":
        gc = min(gpt, _FOLDED_GROUPS)
    else:
        gc = max(1, min(gpt, _SLOT_ROWS // gs))
    # units per metadata stage: at least _ONEHOT_STAGE_UNITS, and a number
    # whose group rows span a multiple of 16 bytes, as TMA 1-D copies need
    groups = ((32 // gs) * gs if gs <= 32 else gs) // gs
    step = 4 // math.gcd(4, groups)
    warps = _ONEHOT_WARPS
    units = -(-_ONEHOT_STAGE_UNITS // step) * step
    return Geometry(gc=gc, dc=dc, warps=warps, stage_units=units,
                    smem_bytes=_onehot_smem(gs, ont, dc, warps, units))


def group_aggregate_plain(feat_padded: torch.Tensor, nbrs: torch.Tensor,
                          edge_val: torch.Tensor, local_node: torch.Tensor,
                          tile_node_block: torch.Tensor, *, ont: int,
                          out_rows: int) -> torch.Tensor:
    """The plain PyTorch version on any device, counted in `launches`."""
    launches[PLAIN] += 1
    return group_aggregate_ref(feat_padded, nbrs, edge_val, local_node,
                               tile_node_block, ont, out_rows)


def group_aggregate(feat_padded: torch.Tensor, nbrs: torch.Tensor,
                    edge_val: torch.Tensor, local_node: torch.Tensor,
                    tile_node_block: torch.Tensor, tile_window: torch.Tensor,
                    run_start: torch.Tensor, *, gs: int, gpt: int, ont: int,
                    src_win: int, dt: int, out_rows: int,
                    variant: str = "folded",
                    run_order: torch.Tensor | None = None) -> torch.Tensor:
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
    run_order : (R,) int32, the order in which the direct kernel launches
        the runs (`DeviceSchedule.run_order`: longest first, so the launch
        does not end on a long run started late); its CUDA path needs it.
        The plain version and the one-hot kernels do not read it.

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
    check_arg("nbrs", nbrs, torch.int32, (T, gpt, gs), dev)
    check_arg("edge_val", edge_val, torch.float32, (T, gpt, gs), dev)
    check_arg("local_node", local_node, torch.int32, (T, gpt), dev)
    check_arg("tile_node_block", tile_node_block, torch.int32, (T,), dev)
    check_arg("tile_window", tile_window, torch.int32, (T,), dev)
    if run_start.dim() != 1 or run_start.numel() < 2:
        raise ValueError("run_start must be (R+1,) with R >= 1")
    check_arg("run_start", run_start, torch.int32, run_start.shape, dev)
    num_runs = run_start.numel() - 1

    geo = launch_geometry(variant, gs=gs, gpt=gpt, ont=ont, dt=dt)
    if geo.smem_bytes > H100_SXM.smem_per_block:
        raise ValueError(f"{variant} at gs={gs} gpt={gpt} ont={ont} dt={dt} "
                         f"needs {geo.smem_bytes} B of shared memory per "
                         f"block (> {H100_SXM.smem_per_block} B)")
    if variant == "direct":
        if run_order is None:
            raise ValueError("direct launches the runs in run_order: pass "
                             "DeviceSchedule.run_order")
        check_arg("run_order", run_order, torch.int32, (num_runs,), dev)
        # a lane loads _GATHER_COLS neighbouring columns of a row at once
        if dt % _GATHER_COLS:
            raise ValueError(f"direct needs dt a multiple of {_GATHER_COLS}, "
                             f"got dt={dt}")
        _check_aligned(feat_padded=feat_padded)
    else:
        # TMA 1-D copies take 16-byte aligned spans of a run's metadata;
        # a lane loads two adjacent feature columns at once
        if gpt % 4 or dt % 2:
            raise ValueError(f"{variant} needs gpt % 4 == 0 and an even dt, "
                             f"got gpt={gpt} dt={dt}")
        _check_aligned(feat_padded=feat_padded, nbrs=nbrs, edge_val=edge_val,
                       local_node=local_node)
    out = torch.empty((out_rows, d_pad), dtype=torch.float32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    i = ctypes.c_int
    dcode = _DTYPE_CODE[feat_padded.dtype]
    with torch.cuda.device(dev):
        if variant == "direct":
            lib = build.load("group_aggregate_gather")
            fn = bind(lib, "repro_group_aggregate_gather")
            code = fn(i(dcode), ptr(feat_padded), ptr(nbrs), ptr(edge_val),
                      ptr(local_node), ptr(tile_node_block), ptr(run_start),
                      ptr(run_order), ptr(out), i(num_runs), i(gs), i(gpt),
                      i(ont), i(d_pad), i(geo.dc), i(geo.smem_bytes), stream)
        else:
            lib = build.load("group_aggregate_onehot")
            fn = bind(lib, "repro_group_aggregate_onehot")
            code = fn(i(int(variant == "folded")), i(dcode), ptr(feat_padded),
                      ptr(nbrs), ptr(edge_val), ptr(local_node),
                      ptr(tile_node_block), ptr(tile_window), ptr(run_start),
                      ptr(out), i(num_runs), i(gs), i(gpt), i(ont),
                      i(src_win), i(d_pad), i(geo.warps),
                      i(geo.stage_units), i(geo.dc), i(geo.smem_bytes),
                      stream)
    raise_on(lib, code, KERNEL_OF_VARIANT[variant])
    launches[KERNEL_OF_VARIANT[variant]] += 1
    return out


def group_edge_grad_plain(grad_padded: torch.Tensor,
                          feat_padded: torch.Tensor, nbrs: torch.Tensor,
                          local_node: torch.Tensor,
                          tile_node_block: torch.Tensor, *,
                          ont: int) -> torch.Tensor:
    """The plain PyTorch version on any device, counted in `launches`."""
    launches[EDGE_GRAD_PLAIN] += 1
    return group_edge_grad_ref(grad_padded, feat_padded, nbrs, local_node,
                               tile_node_block, ont)


def group_edge_grad(grad_padded: torch.Tensor, feat_padded: torch.Tensor,
                    nbrs: torch.Tensor, local_node: torch.Tensor,
                    tile_node_block: torch.Tensor, tile_window: torch.Tensor,
                    run_start: torch.Tensor, *, gs: int, gpt: int, ont: int,
                    src_win: int, dt: int, variant: str = "slot_onehot",
                    slot_of_edge: torch.Tensor | None = None) -> torch.Tensor:
    """Per-slot edge-value cotangent over the FORWARD group schedule.

    For slot (t, g, s) holding edge (v <- u): ``out[t,g,s] = <grad[v],
    feat[u]>``, summed over all D_pad columns.

    grad_padded : (out_rows, D_pad) output cotangent, out_rows % ont == 0.
    feat_padded : (N_src_pad, D_pad), the same dtype (float32 | bfloat16 |
        float16); N_src_pad % src_win == 0, D_pad % dt == 0.
    nbrs : (T, gpt, gs) int32; local_node : (T, gpt) int32;
    tile_node_block : (T,) int32, as for `group_aggregate`.
    tile_window, run_start : taken as `group_aggregate` takes them, and
        not read: the kernel follows the real edges, not the runs.
    variant : checked, and otherwise not read: every variant runs the
        block kernel, on any gs.
    slot_of_edge : (E,) int32, the flat slot ``edge_slot * gs + edge_pos``
        of each real edge (`kernels.ops.DeviceSchedule.slot_of_edge`); the
        block kernel computes exactly these slots, so the CUDA path needs
        it.  The plain version does not read it.

    Returns (T, gpt, gs) float32.  Padded slots hold don't-care values; on
    the CUDA path they are left unwritten: callers read only real
    (edge_slot, edge_pos) entries.
    """
    _check_variant(variant)
    if not feat_padded.is_cuda:
        return group_edge_grad_plain(grad_padded, feat_padded, nbrs,
                                     local_node, tile_node_block, ont=ont)

    dev = feat_padded.device
    n_src, d_pad = feat_padded.shape
    out_rows = grad_padded.shape[0]
    if feat_padded.dtype not in _DTYPE_CODE:
        raise TypeError(f"feat dtype {feat_padded.dtype} not supported; "
                        f"one of {list(_DTYPE_CODE)}")
    if not feat_padded.is_contiguous():
        raise ValueError("feat_padded must be contiguous")
    check_arg("grad_padded", grad_padded, feat_padded.dtype,
              (out_rows, d_pad), dev)
    if n_src % src_win or d_pad % dt or out_rows % ont:
        raise ValueError(f"padding mismatch: n_src={n_src} src_win={src_win} "
                         f"d_pad={d_pad} dt={dt} out_rows={out_rows} ont={ont}")
    T = nbrs.shape[0]
    check_arg("nbrs", nbrs, torch.int32, (T, gpt, gs), dev)
    check_arg("local_node", local_node, torch.int32, (T, gpt), dev)
    check_arg("tile_node_block", tile_node_block, torch.int32, (T,), dev)

    kname = EDGE_GRAD_KERNEL
    if slot_of_edge is None:
        raise ValueError(f"{kname} computes the real slots only: pass "
                         f"slot_of_edge (DeviceSchedule.slot_of_edge)")
    edges = slot_of_edge.numel()
    if slot_of_edge.dim() != 1 or not 0 < edges <= nbrs.numel():
        raise ValueError(f"slot_of_edge must be (E,) with 0 < E <= "
                         f"{nbrs.numel()} slots, got "
                         f"{tuple(slot_of_edge.shape)}")
    check_arg("slot_of_edge", slot_of_edge, torch.int32, slot_of_edge.shape,
              dev)
    # a lane loads 16 bytes of a row
    vec = 16 // feat_padded.element_size()
    if d_pad % vec:
        raise ValueError(f"{kname} needs D_pad a multiple of {vec} (16 "
                         f"bytes of {feat_padded.dtype}), got {d_pad}")
    _check_aligned(grad_padded=grad_padded, feat_padded=feat_padded)
    lib = build.load("group_edge_grad")
    fn = bind(lib, "repro_group_edge_grad_block")
    out = torch.empty((T, gpt, gs), dtype=torch.float32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    i = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(i(_DTYPE_CODE[feat_padded.dtype]), ptr(grad_padded),
                  ptr(feat_padded), ptr(nbrs), ptr(local_node),
                  ptr(tile_node_block), ptr(slot_of_edge), ptr(out), i(edges),
                  i(gs), i(gpt), i(ont), i(d_pad), stream)
    raise_on(lib, code, kname)
    launches[kname] += 1
    return out
