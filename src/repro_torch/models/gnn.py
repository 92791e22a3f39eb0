"""GNN models (the paper's own benchmarks): GCN, GIN and GAT on the
GNNAdvisor aggregation engine.

Port of `src/repro/models/gnn.py` (`GNNConfig`, `gcn_edge_values`,
`init_gnn_params`, `GNNModel.logits`, `build_gnn`, plus `params_from_jax`
to carry the reference's weights across).  Forward only in this slice;
losses, training steps and the sampled / sharded forwards come with their
slices.

Faithful to the paper's §4.2 placement rule:
  * GCN (type-1): REDUCE DIM FIRST — X @ W before aggregation, so the
    kernel aggregates the small hidden dim.
  * GIN / GAT (type-2): aggregation on the full input dim.

Parameters are a plain ``dict[str, torch.Tensor]`` (float32) with the
reference's key names and shapes:

  * ``w{i}`` — layer i's projection, (dims[i], dims[i+1]) for GCN/GAT,
    (dims[i], hidden_dim) for GIN;
  * ``w{i}b`` — GIN's second MLP matrix, (hidden_dim, dims[i+1]);
  * ``a{i}s`` / ``a{i}d`` — GAT's source / destination attention vectors,
    (dims[i+1],);

with dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [num_classes].
`params_from_jax` converts a reference pytree (numpy arrays under those
keys) into this dict unchanged, which is how the parity tests feed both
packages the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.advisor import advise
from repro_torch.core.aggregate import PlanExecutor
from repro_torch.core.plan import Plan
from repro_torch.device import resolve_device, set_matmul_precision
from repro_torch.graphs.csr import CSRGraph

Params = Dict[str, torch.Tensor]

__all__ = ["GNNConfig", "GNNModel", "build_gnn", "gcn_edge_values",
           "init_gnn_params", "params_from_jax"]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    arch: str = "gcn"           # "gcn" | "gin" | "gat"
    in_dim: int = 128
    hidden_dim: int = 64
    num_classes: int = 8
    num_layers: int = 2
    gin_eps: float = 0.0
    gat_slope: float = 0.2      # LeakyReLU slope for attention logits
    backend: str = "cuda"       # "cuda" | "torch"
    # feature/activation dtype policy: "float32" | "bfloat16".  Parameters
    # stay float32; products and the aggregation kernel run on feat_dtype
    # operands with f32 accumulation; logits come back as f32.
    feat_dtype: str = "float32"
    device: str = "cuda"        # where parameters, schedules and features live

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.feat_dtype)


def _mmul(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Policy matmul: operands at the compute dtype, accumulation in f32
    (`set_matmul_precision` forbids reduced-precision reductions), result
    at the compute dtype.  A plain float32 product for f32."""
    return torch.matmul(a.to(cdt), b.to(cdt))


def gcn_edge_values(g: CSRGraph) -> tuple[CSRGraph, np.ndarray]:
    """Add self-loops and compute \\hat{A}'s 1/sqrt(d_u d_v) edge weights."""
    g2 = g.with_self_loops()
    deg = g2.degrees.astype(np.float64)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    rows, cols = g2.to_coo()
    vals = (inv_sqrt[rows] * inv_sqrt[cols]).astype(np.float32)
    return g2, vals


@dataclasses.dataclass
class GNNModel:
    cfg: GNNConfig
    plan: Plan
    executor: PlanExecutor
    params: Params

    def logits(self, params: Params, feat: torch.Tensor) -> torch.Tensor:
        """feat (N, in_dim) in the plan's node order, on the executor's
        device -> (N, num_classes) float32 (intermediate activations follow
        ``cfg.feat_dtype``)."""
        cfg = self.cfg
        cdt = cfg.compute_dtype
        x = feat
        for i in range(cfg.num_layers):
            w = params[f"w{i}"]
            if cfg.arch == "gcn":
                x = self.executor(_mmul(x, w, cdt))
            elif cfg.arch == "gat":
                # single-head GAT with DYNAMIC per-edge values through the
                # same group schedule; attention scores stay f32
                z = _mmul(x, w, cdt)                           # (N, h)
                s_src = z.float() @ params[f"a{i}s"]
                s_dst = z.float() @ params[f"a{i}d"]
                rows, cols = self._edges
                e = torch.nn.functional.leaky_relu(
                    s_dst[rows] + s_src[cols], negative_slope=cfg.gat_slope)
                emax = e.max() if e.numel() else 0.0
                wgt = torch.exp(e - emax)
                num = self.executor.aggregate_edges(z, wgt)
                den = self.executor.aggregate_edges(
                    torch.ones((z.shape[0], 1), dtype=cdt, device=z.device),
                    wgt)
                x = num.float() / torch.clamp(den.float(), min=1e-9)
                if i < cfg.num_layers - 1:
                    x = torch.nn.functional.elu(x)
            else:
                # GIN: aggregate full-dim, then (1+eps)*x + agg -> 2-layer MLP
                agg = self.executor(x.to(cdt))
                h = (1.0 + cfg.gin_eps) * x.to(cdt) + agg.to(cdt)
                x = _mmul(torch.relu(_mmul(h, w, cdt)), params[f"w{i}b"], cdt)
            if cfg.arch == "gcn" and i < cfg.num_layers - 1:
                x = torch.relu(x)
        return x.float()

    @property
    def _edges(self):
        cache = getattr(self, "_edges_cache", None)
        if cache is None:
            rows, cols = self.plan.graph.to_coo()
            dev = self.executor.device
            cache = (torch.as_tensor(rows, dtype=torch.int64, device=dev),
                     torch.as_tensor(cols, dtype=torch.int64, device=dev))
            self._edges_cache = cache
        return cache


def init_gnn_params(cfg: GNNConfig,
                    generator: Optional[torch.Generator] = None) -> Params:
    """Parameter init alone (the serving engine never plans the resident
    graph).  Same shapes and scales as the reference; the numbers differ
    (a `torch.Generator` on the CPU, then moved to ``cfg.device``)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = resolve_device(cfg.device)
    dims = [cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [cfg.num_classes]

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen) / np.sqrt(scale)).to(dev)

    params: Params = {}
    for i in range(cfg.num_layers):
        if cfg.arch in ("gcn", "gat"):
            params[f"w{i}"] = normal(dims[i], dims[i + 1], scale=dims[i])
            if cfg.arch == "gat":
                params[f"a{i}s"] = normal(dims[i + 1], scale=dims[i + 1])
                params[f"a{i}d"] = normal(dims[i + 1], scale=dims[i + 1])
        else:
            params[f"w{i}"] = normal(dims[i], cfg.hidden_dim, scale=dims[i])
            params[f"w{i}b"] = normal(cfg.hidden_dim, dims[i + 1],
                                      scale=cfg.hidden_dim)
    return params


def params_from_jax(params: Dict[str, np.ndarray], device) -> Params:
    """Carry a reference parameter pytree across: every ``w{i}``,
    ``w{i}b``, ``a{i}s``, ``a{i}d`` array (numpy, or anything
    `np.asarray` takes) becomes a float32 tensor on ``device`` under the
    same key with the same shape."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in params.items()}


def build_gnn(g: CSRGraph, cfg: GNNConfig, *,
              generator: Optional[torch.Generator] = None,
              reorder: str = "auto", tune_iters: int = 6,
              config=None, seed: int = 0) -> GNNModel:
    """Run the advisor on the graph, build the plan executor + parameters
    on ``cfg.device``."""
    set_matmul_precision()
    kw = dict(arch=cfg.arch, in_dim=cfg.in_dim, hidden_dim=cfg.hidden_dim,
              num_layers=cfg.num_layers, reorder=reorder,
              tune_iters=tune_iters, config=config, seed=seed,
              feat_dtype=cfg.feat_dtype)
    if cfg.arch == "gcn":
        g2, vals = gcn_edge_values(g)
        plan = advise(g2, edge_vals=vals, **kw)
    else:
        plan = advise(g, **kw)
    executor = PlanExecutor(plan, backend=cfg.backend, device=cfg.device)
    params = init_gnn_params(cfg, generator)
    return GNNModel(cfg=cfg, plan=plan, executor=executor, params=params)
