"""Modeling (paper §7.1) — analytical performance model, priced for Hopper.

Port of `src/repro/core/model.py`.  Two model layers:

  1. `paper_eq2_latency` — the literal Eq. 2 latency surrogate from the
     paper (gs -> gs, tpb -> gpt, dw -> dt), unchanged.

  2. `KernelModel` — a white-box model of the port's CUDA kernels: tile
     counts predicted from input statistics (the reference's estimator,
     unchanged), then priced by the work each kernel's live-slot walk does,
     with costs measured on the card per gather variant.  Eq. 4 is a
     shared-memory bound again, as in the paper: `smem_working_set` is
     exactly what one thread block of the port's kernels allocates
     (`repro_torch.kernels.group_aggregate.launch_geometry`), and
     `config_infeasibility` checks it against the block limit.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.extractor import GraphProps
from repro_torch.hw import H100_SXM, GPUSpec

__all__ = ["AggConfig", "paper_eq2_latency", "KernelModel", "KernelCosts",
           "KERNEL_COSTS", "smem_working_set", "config_infeasibility",
           "feat_dtype_align", "feat_dtype_bytes", "predict_tiles"]

# The end-to-end dtype policy's vocabulary: bytes per element and the
# dim-tile alignment unit.  The unit is one 32-byte memory sector (8 f32 or
# 16 bf16/f16 elements), so a dim tile is a whole number of sectors; it is
# the same unit the reference uses, so both packages pad widths alike.
_FEAT_DTYPES = {"float32": (4, 8), "bfloat16": (2, 16), "float16": (2, 16)}


def feat_dtype_bytes(feat_dtype: str) -> int:
    """Bytes per feature element for a policy dtype name."""
    try:
        return _FEAT_DTYPES[feat_dtype][0]
    except KeyError:
        raise ValueError(
            f"unknown feat_dtype {feat_dtype!r}; one of {sorted(_FEAT_DTYPES)}"
        ) from None


def feat_dtype_align(feat_dtype: str) -> int:
    """Dim-tile alignment unit (elements) for a policy dtype name."""
    try:
        return _FEAT_DTYPES[feat_dtype][1]
    except KeyError:
        raise ValueError(
            f"unknown feat_dtype {feat_dtype!r}; one of {sorted(_FEAT_DTYPES)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class AggConfig:
    """The tunable hyper-parameters (paper: gs, tpb, dw; + window).

    Fields and defaults are the reference's, so plans and npz files stay
    comparable across the two packages."""

    gs: int = 16          # group size (paper gs)
    gpt: int = 16         # groups per tile (paper tpb analogue)
    dt: int = 128         # dim-tile width (paper dw analogue)
    src_win: int = 512    # feature-window rows of one tile
    ont: int = 8          # output rows per node block
    variant: str = "folded"
    feat_dtype: str = "float32"   # feature/activation dtype policy

    def astuple(self):
        return (self.gs, self.gpt, self.dt, self.src_win, self.ont)

    @property
    def bytes_feat(self) -> int:
        return feat_dtype_bytes(self.feat_dtype)


# ---------------------------------------------------------------------------
# 1. Paper Eq. 2, faithfully.
# ---------------------------------------------------------------------------

def paper_eq2_latency(props: GraphProps, dim: int, cfg: AggConfig,
                      *, max_tpb: int = 1024) -> float:
    """Eq. 2 of the paper (surrogate units, lower = better).

    Latency = E*D / (gs * |dw - D/3| * |tpb - sqrt(max_tpb)|)
              * (1 + |gs - alpha*N/E|)
    """
    n, e, d = props.num_nodes, props.num_edges, float(dim)
    gs, tpb, dw = float(cfg.gs), float(cfg.gpt), float(cfg.dt)
    denom = gs * max(abs(dw - d / 3.0), 0.5) * max(abs(tpb - math.sqrt(max_tpb)), 0.5)
    pivot = props.alpha * (n / max(e, 1))
    return (e * d) / denom * (1.0 + abs(gs - pivot))


# ---------------------------------------------------------------------------
# 2. White-box model of the port's kernels.
# ---------------------------------------------------------------------------

def predict_tiles(props: GraphProps, cfg: AggConfig) -> float:
    """Predict the tile count T from input statistics (the reference's
    estimator: the schedule is the same on both packages)."""
    n, e = props.num_nodes, max(props.num_edges, 1)
    avg_deg = e / max(n, 1)
    win_per_node = 1.0 + min(avg_deg - 1.0, avg_deg * min(
        1.0, props.numbering_spread * n / max(cfg.src_win, 1))) if avg_deg > 1 else 1.0
    deg_per_win = avg_deg / win_per_node
    groups_per_node = win_per_node * (1.0 + max(deg_per_win - 1.0, 0.0) // cfg.gs)
    groups = n * groups_per_node
    node_blocks = max(n / cfg.ont, 1.0)
    buckets = node_blocks * max(1.0, min(win_per_node * cfg.ont,
                                         n / max(cfg.src_win, 1)))
    padded = groups + 0.5 * cfg.gpt * buckets
    return max(padded / cfg.gpt, 1.0)


def smem_working_set(cfg: AggConfig) -> int:
    """Shared-memory bytes one thread block allocates — Eq. 4 of the paper.

    (Reference: `vmem_working_set`.)  Taken from the kernels' own launch
    geometry at the config's dim tile, so the bound prices exactly what a
    launch asks for (a narrower feature width only shrinks the tile):

      * ``direct``: one ont x dc f32 partial per warp and lane group (dc =
        the dim tile up to 128 columns) and each warp's live-slot list;
      * ``folded`` / ``slot_onehot``: the slot-metadata ring, one ont x dc
        f32 partial per warp (and slot lane group) and each warp's
        live-slot list.

    Features are converted to f32 in registers, so the bound does not
    depend on ``feat_dtype``.
    """
    from repro_torch.kernels.group_aggregate import launch_geometry
    return launch_geometry(cfg.variant, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                           dt=cfg.dt).smem_bytes


def config_infeasibility(cfg: AggConfig, *,
                         hw: GPUSpec = H100_SXM) -> str | None:
    """Eq. 3 + Eq. 4 feasibility on the card, and the launch limits of the
    config's kernel: None when the config is feasible, else a
    human-readable reason naming the violated constraint."""
    ws = smem_working_set(cfg)
    if ws > hw.smem_per_block:
        return (f"Eq. 4 shared-memory working set {ws}B > {hw.name} "
                f"per-block limit {hw.smem_per_block}B")
    # Eq. 3: per-group work must stay a sane single-unit budget
    if cfg.gs * cfg.dt > 64 * 1024:
        return f"Eq. 3 per-group work gs*dt={cfg.gs * cfg.dt} > 64Ki"
    align = feat_dtype_align(cfg.feat_dtype)
    if cfg.dt % align != 0:
        return (f"dt={cfg.dt} not a multiple of the {cfg.feat_dtype} "
                f"alignment unit {align}")
    if cfg.src_win % 8 != 0:
        return f"src_win={cfg.src_win} not a multiple of 8"
    # the one-hot kernels copy a run's group rows in 16-byte spans (the dim
    # tile is already even: the alignment unit above is 8 or 16)
    if cfg.variant != "direct" and cfg.gpt % 4 != 0:
        return (f"gpt={cfg.gpt} not a multiple of 4, which the {cfg.variant} "
                f"kernel's metadata copies need")
    return None


@dataclasses.dataclass(frozen=True)
class KernelCosts:
    """Measured costs (seconds) of one gather kernel's executor call.

    ``device_s``: the device's fixed time of one call (the padding copy,
    the launch, the output slice); ``block_s``: one thread block's fixed
    chain of dependent round trips (the run's setup, the last flush, the
    final sum of the warps' partials); ``slot_s``: one slot of the run's
    tiles walked by a block, live or padded (its metadata read and the
    live test); ``live_s``: one live slot's row read and multiply-add in a
    block, per column of the block's slice; ``chain_s``: one live slot of
    the longest run, per column of the block's slice, on that block's
    serial walk."""

    device_s: float
    block_s: float
    slot_s: float
    live_s: float
    chain_s: float


# Fitted by least squares on log time (`tools/fit_kernel_costs.py`) to the
# 42 device-only p50s of `obs.profile.measure` in
# `tools/kernel_cost_points.json`: 24 of the one-hot kernel, 18 of the
# gather kernel, from two runs of `chip_smoke.py --phases hub,profile` on
# one NVIDIA H100 80GB HBM3 at a 700 W power limit (phase 8's schedules:
# the pubmed replica's train-ready plans at D 16, ego-batch plans at D 16
# and 500, the measured tuner's candidates on the pubmed replica at D 500
# and on full reddit at D 64, full reddit's gather plan at D 64).  Every
# point lands within 0.71-1.34x of the model.  ``chain_s`` is held out of
# the fit: the one-hot kernel's longest run alone (the hub probe of the
# first of those runs: 30.5 us for 2,820 live slots at D 16) and the
# gather kernel's longest run at 128 columns (29.2 ns a live slot).
# slot_onehot runs the one-hot kernel's walk and is priced as folded (it
# is not raced, so not fitted).
KERNEL_COSTS = {
    "folded": KernelCosts(device_s=5.24e-6, block_s=7.74e-6,
                          slot_s=2.29e-9, live_s=0.584e-9,
                          chain_s=0.59e-9),
    "direct": KernelCosts(device_s=8.30e-6, block_s=3.90e-6,
                          slot_s=1.64e-9, live_s=0.346e-9,
                          chain_s=0.228e-9),
}
KERNEL_COSTS["slot_onehot"] = KERNEL_COSTS["folded"]
# the host's share of one executor call (checks, padding, the launch): the
# median of wall p50 - device p50 over the same 42 points, same card
CALL_S = 83.5e-6
# both kernels run 256 threads a block at up to 64 registers a thread
# (ptxas), so the register file holds 4 blocks an SM
_BLOCKS_PER_SM = 4


@dataclasses.dataclass
class KernelModel:
    """Latency model of the port's group-aggregation kernels, priced by the
    work their live-slot walks do on the card.

    Both kernels give a thread block to each run of tiles sharing a node
    block and each column slice of ``dc`` columns (`launch_geometry`), and
    each block's 8 warps walk every slot of the run's tiles, gathering the
    live ones' rows.  So a call costs `CALL_S` of host work plus the
    kernel's ``device_s`` plus the largest of

      * the work term: every block's fixed chain (``block_s``), every slot
        walked (``slot_s``) and every live slot's row slice (``live_s`` a
        column), over all column slices, shared by the blocks the card
        holds at once (SMs x blocks an SM, by shared memory and
        registers);
      * the chain term: the longest run's block alone, ``block_s`` plus
        its live slots' serial walk (``chain_s`` a slot and column; the
        gather kernel launches its runs longest first so that this is a
        floor, not a tail);
      * the memory term: every slot's metadata, each group's row index,
        each source row once and each output row once, over the memory
        rate; and the FMA term, 2 FLOP per live slot and column.

    The longest run's live slots are estimated from the degree statistics
    (the highest-degree node and its node block's mean degrees), the runs
    as the node blocks (at most the tiles).  Constants: `KERNEL_COSTS`,
    `CALL_S`.
    """

    hw: GPUSpec = H100_SXM

    def terms(self, props: GraphProps, dim: int, cfg: AggConfig,
              *, tiles: float | None = None) -> dict:
        from repro_torch.kernels.group_aggregate import launch_geometry
        c = KERNEL_COSTS[cfg.variant]
        T = float(tiles if tiles is not None else predict_tiles(props, cfg))
        dt = min(cfg.dt, -(-max(dim, 1) // 8) * 8)
        geo = launch_geometry(cfg.variant, gs=cfg.gs, gpt=cfg.gpt,
                              ont=cfg.ont, dt=dt)
        n = props.num_nodes
        slots = T * cfg.gpt * cfg.gs
        live = min(float(props.num_edges), slots)
        runs = min(T, math.ceil(n / cfg.ont))
        slices = math.ceil(max(dim, 1) / geo.dc)
        hub = min(live, props.max_degree + (cfg.ont - 1) * props.avg_degree)
        resident = self.hw.num_sms * max(1, min(
            _BLOCKS_PER_SM, self.hw.smem_per_sm // geo.smem_bytes))
        t_work = slices * (runs * c.block_s + slots * c.slot_s
                           + live * geo.dc * c.live_s) / resident
        t_chain = c.block_s + hub * geo.dc * c.chain_s
        flops = 2.0 * live * dim
        total_bytes = (slots * 8 + T * cfg.gpt * 4
                       + n * dim * (cfg.bytes_feat + 4))
        t_compute = flops / self.hw.peak_flops_f32
        t_memory = total_bytes / self.hw.hbm_bw
        t_device = c.device_s + max(t_work, t_chain, t_memory, t_compute)
        return {
            "tiles": T, "blocks": runs * slices, "flops": flops,
            "bytes": total_bytes, "smem_bytes": geo.smem_bytes,
            "t_compute": t_compute, "t_memory": t_memory,
            "t_work": t_work, "t_chain": t_chain,
            "t_overhead": CALL_S + c.device_s,
            "t_device": t_device, "latency": CALL_S + t_device,
        }

    def latency(self, props: GraphProps, dim: int, cfg: AggConfig, **kw) -> float:
        return self.terms(props, dim, cfg, **kw)["latency"]
