"""Modeling (paper §7.1) — analytical performance model, priced for Hopper.

Port of `src/repro/core/model.py`.  Two model layers:

  1. `paper_eq2_latency` — the literal Eq. 2 latency surrogate from the
     paper (gs -> gs, tpb -> gpt, dw -> dt), unchanged.

  2. `KernelModel` — a white-box three-term model of the port's CUDA
     kernels: tile counts predicted from input statistics (unchanged), then
     priced with the `H100_SXM` constants per gather variant.  Eq. 4 is a
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

__all__ = ["AggConfig", "paper_eq2_latency", "KernelModel", "smem_working_set",
           "config_infeasibility", "feat_dtype_align", "feat_dtype_bytes",
           "predict_tiles"]

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

      * ``direct``: the ont x dt f32 node-block accumulator;
      * ``folded`` / ``slot_onehot``: node-block accumulator, per-group
        accumulator, staged feature chunk and gather-matrix chunk, all f32
        (features are converted when staged, so the bound does not depend
        on ``feat_dtype``).
    """
    from repro_torch.kernels.group_aggregate import launch_geometry
    return launch_geometry(cfg.variant, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                           dt=cfg.dt).smem_bytes


def config_infeasibility(cfg: AggConfig, *,
                         hw: GPUSpec = H100_SXM) -> str | None:
    """Eq. 3 + Eq. 4 feasibility on the card: None when the config is
    feasible, else a human-readable reason naming the violated
    constraint."""
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
    return None


@dataclasses.dataclass
class KernelModel:
    """Three-term latency model of the port's group-aggregation kernels.

    Both kernels run on the CUDA cores in f32 (plain FMA), so compute is
    priced at ``peak_flops_f32`` for every feature dtype; the feature dtype
    only changes the bytes.  Blocks = runs (~node blocks) x column slices;
    the per-block overhead is the spec's ASSUMED ``block_overhead_s``,
    charged per wave of ``num_sms`` blocks, until it is measured.
    """

    hw: GPUSpec = H100_SXM

    def terms(self, props: GraphProps, dim: int, cfg: AggConfig,
              *, tiles: float | None = None) -> dict:
        from repro_torch.kernels.group_aggregate import launch_geometry
        bytes_feat = cfg.bytes_feat
        T = float(tiles if tiles is not None else predict_tiles(props, cfg))
        dt = min(cfg.dt, -(-max(dim, 1) // 8) * 8)
        geo = launch_geometry(cfg.variant, gs=cfg.gs, gpt=cfg.gpt,
                              ont=cfg.ont, dt=dt)
        slots = T * cfg.gpt * cfg.gs
        n_blocks = max(props.num_nodes / cfg.ont, 1.0)
        if cfg.variant == "direct":
            flops = 2.0 * slots * dim
            # every slot reads one row slice of the feature operand
            bytes_feat_total = slots * dim * bytes_feat
            cols = dt
        else:
            rows = cfg.gpt * (cfg.gs if cfg.variant == "slot_onehot" else 1)
            # dense product over the whole window + the W build compares
            flops = 2.0 * T * rows * cfg.src_win * dim \
                + T * cfg.gpt * cfg.gs * cfg.src_win * math.ceil(dim / geo.dc)
            # the window is staged once per group chunk
            chunks = math.ceil(cfg.gpt / max(geo.gc, 1))
            bytes_feat_total = T * chunks * cfg.src_win * dim * bytes_feat
            cols = geo.dc
        bytes_meta = slots * 8 + T * cfg.gpt * 4
        bytes_out = n_blocks * cfg.ont * dim * 4
        total_bytes = bytes_feat_total + bytes_meta + bytes_out
        t_compute = flops / self.hw.peak_flops_f32
        t_memory = total_bytes / self.hw.hbm_bw
        blocks = n_blocks * math.ceil(dim / cols)
        t_overhead = math.ceil(blocks / self.hw.num_sms) * self.hw.block_overhead_s
        return {
            "tiles": T, "blocks": blocks, "flops": flops,
            "bytes": total_bytes, "smem_bytes": geo.smem_bytes,
            "t_compute": t_compute, "t_memory": t_memory,
            "t_overhead": t_overhead,
            "latency": max(t_compute, t_memory) + t_overhead,
        }

    def latency(self, props: GraphProps, dim: int, cfg: AggConfig, **kw) -> float:
        return self.terms(props, dim, cfg, **kw)["latency"]
