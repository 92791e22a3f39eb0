"""GNN models (the paper's own benchmarks): GCN, GIN and GAT on the
GNNAdvisor aggregation engine.

Port of `src/repro/models/gnn.py` (`GNNConfig`, `gcn_edge_values`,
`init_gnn_params`, `GNNModel.logits` / `loss`, `build_gnn`,
`planted_labels`, `structural_labels`, `make_gnn_train_step`, the sampled
block forward `gnn_block_logits` / `gnn_block_loss`, the per-rank
sharded forward `gnn_sharded_logits`, plus `params_from_jax` to carry
the reference's weights across).

Training runs on either backend: `build_gnn` attaches the transposed
backward schedule when the backend is ``"cuda"`` (or when
``with_backward=True`` is forced), so ``loss.backward()`` runs the CUDA
aggregation kernels over the transposed schedule and, for GAT, the
edge-gradient kernels (`repro_torch.kernels.ops`).

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
           "gnn_block_logits", "gnn_block_loss", "gnn_sharded_logits",
           "init_gnn_params",
           "make_gnn_train_step", "params_from_jax", "planted_labels",
           "structural_labels"]


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
        if cfg.arch != "gat":
            # the block forward with this graph's executor at every layer
            # (each crop keeps every row)
            return gnn_block_logits(cfg, params, feat,
                                    [self.executor] * cfg.num_layers)
        cdt = cfg.compute_dtype
        x = feat
        for i in range(cfg.num_layers):
            # single-head GAT with DYNAMIC per-edge values through the same
            # group schedule; attention scores stay f32
            z = _mmul(x, params[f"w{i}"], cdt)                 # (N, h)
            s_src = z.float() @ params[f"a{i}s"]
            s_dst = z.float() @ params[f"a{i}d"]
            rows, cols = self._edges
            e = torch.nn.functional.leaky_relu(
                s_dst[rows] + s_src[cols], negative_slope=cfg.gat_slope)
            # a constant shift, outside the gradient (the reference's
            # jax.lax.stop_gradient)
            emax = e.max().detach() if e.numel() else 0.0
            wgt = torch.exp(e - emax)
            num = self.executor.aggregate_edges(z, wgt)
            den = self.executor.aggregate_edges(
                torch.ones((z.shape[0], 1), dtype=cdt, device=z.device), wgt)
            x = num.float() / torch.clamp(den.float(), min=1e-9)
            if i < cfg.num_layers - 1:
                x = torch.nn.functional.elu(x)
        return x.float()

    def loss(self, params: Params, feat: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None):
        """Masked softmax cross-entropy over the logits: ``(loss,
        {"loss", "accuracy"})`` (0-d float32 tensors)."""
        return _masked_xent(self.logits(params, feat), labels, mask)

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


def _masked_xent(lg: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
    """Masked softmax cross-entropy + accuracy over (N, C) logits."""
    logp = torch.log_softmax(lg, dim=-1)
    per = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if mask is None:
        mask = torch.ones_like(per)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per * mask).sum() / denom
    acc = ((lg.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc}


def gnn_block_logits(cfg: GNNConfig, params: Params, feat: torch.Tensor,
                     executors) -> torch.Tensor:
    """Sampled mini-batch forward: one bipartite block per layer.

    ``executors[l]`` aggregates layer l's block (square CSR over the
    block's source frontier, dst nodes first — `repro_torch.sampling.
    neighbor`).  ``feat`` is (num_src_0, in_dim) in block 0's local order.
    After each layer the activation is cropped to the next block's
    (padded) source count: the rows dropped are the nodes no deeper layer
    reads.  Returns (num_nodes_last, num_classes) float32; rows beyond the
    seed count are padding (mask them in the loss).

    GCN keeps its reduce-dim-first placement; GIN aggregates the full
    width, then runs its MLP.  GAT needs per-block dynamic edge values,
    which the sampled path does not carry (the reference refuses it too).
    """
    if cfg.arch not in ("gcn", "gin"):
        raise NotImplementedError(
            f"sampled block forward supports gcn/gin, not {cfg.arch!r}")
    cdt = cfg.compute_dtype
    x = feat
    for i, ex in enumerate(executors):
        w = params[f"w{i}"]
        if cfg.arch == "gcn":
            x = ex(_mmul(x, w, cdt))
            if i < cfg.num_layers - 1:
                x = torch.relu(x)
        else:
            # aggregate full-dim, then (1+eps)*x + agg -> 2-layer MLP
            agg = ex(x.to(cdt))
            h = (1.0 + cfg.gin_eps) * x.to(cdt) + agg.to(cdt)
            x = _mmul(torch.relu(_mmul(h, w, cdt)), params[f"w{i}b"], cdt)
        if i + 1 < len(executors):
            x = x[: executors[i + 1].sched.num_nodes]
    return x.float()


def gnn_sharded_logits(cfg: GNNConfig, params: Params,
                       feat_local: torch.Tensor, executor) -> torch.Tensor:
    """Per-rank body of the sharded full-graph forward (port of the
    reference's `gnn_sharded_logits`; `repro_torch.distributed.
    graph_shard` runs it on every rank of a group).

    ``feat_local`` is this rank's (n_local, in_dim) row slice of the
    parent plan's node order; ``executor`` aggregates the shard's OUTPUT
    rows from the full gathered feature matrix (a sub-plan executor from
    `core.shard.shard_plan`: schedule num_nodes == padded global N, local
    rows leading).  Each layer all-gathers the current activations (the
    halo exchange, `graph_shard.gather_rows`, whose backward is the
    reduce-scatter that returns cotangents to their owner ranks),
    aggregates locally, and keeps the local rows.  Returns (n_local,
    num_classes) float32.
    """
    from repro_torch.distributed.graph_shard import gather_rows
    if cfg.arch not in ("gcn", "gin"):
        raise NotImplementedError(
            f"sharded forward supports gcn/gin, not {cfg.arch!r}")
    cdt = cfg.compute_dtype
    n_local = feat_local.shape[0]
    x = feat_local
    for i in range(cfg.num_layers):
        w = params[f"w{i}"]
        if cfg.arch == "gcn":
            # project BEFORE the exchange, in the policy dtype: under bf16
            # the halo all-gather moves half the bytes
            z_full = gather_rows(_mmul(x, w, cdt))
            x = executor(z_full)[:n_local]
            if i < cfg.num_layers - 1:
                x = torch.relu(x)
        else:
            agg = executor(gather_rows(x.to(cdt)))[:n_local]
            h = (1.0 + cfg.gin_eps) * x.to(cdt) + agg.to(cdt)
            x = _mmul(torch.relu(_mmul(h, w, cdt)), params[f"w{i}b"], cdt)
    return x.float()


def gnn_block_loss(cfg: GNNConfig, params: Params, feat: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor, executors):
    """Masked loss over a sampled mini-batch's block chain (labels / mask
    are (num_nodes_last,); mask is 0 on shape-bucket padding rows)."""
    return _masked_xent(gnn_block_logits(cfg, params, feat, executors),
                        labels, mask)


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
              config=None, seed: int = 0,
              with_backward: Optional[bool] = None,
              variant: Optional[str] = None) -> GNNModel:
    """Run the advisor on the graph, build the plan executor + parameters
    on ``cfg.device``.

    with_backward: attach the transposed-schedule backward partition, so
    gradients run through the CUDA kernels.  Default (None) enables it
    exactly when the backend is ``"cuda"``: the ``"torch"`` backend
    differentiates natively, and inference-only use can pass False to skip
    the extra partitioning.

    variant: optional gather kernel stamped onto the plan's config (see
    `repro_torch.core.advisor.plan_for`); None keeps the tuner's.
    """
    set_matmul_precision()
    if with_backward is None:
        with_backward = cfg.backend == "cuda"
    kw = dict(arch=cfg.arch, in_dim=cfg.in_dim, hidden_dim=cfg.hidden_dim,
              num_layers=cfg.num_layers, reorder=reorder,
              tune_iters=tune_iters, config=config, seed=seed,
              with_backward=with_backward, feat_dtype=cfg.feat_dtype,
              variant=variant)
    if cfg.arch == "gcn":
        g2, vals = gcn_edge_values(g)
        plan = advise(g2, edge_vals=vals, **kw)
    else:
        plan = advise(g, **kw)
    executor = PlanExecutor(plan, backend=cfg.backend, device=cfg.device)
    params = init_gnn_params(cfg, generator)
    return GNNModel(cfg=cfg, plan=plan, executor=executor, params=params)


def structural_labels(g: CSRGraph, num_classes: int) -> np.ndarray:
    """Degree-quantile node labels: a deterministic, aggregation-learnable
    task that needs no full-graph teacher forward."""
    deg = g.degrees.astype(np.float64)
    qs = np.quantile(deg, np.linspace(0, 1, num_classes + 1)[1:-1])
    return np.searchsorted(qs, deg, side="right").astype(np.int32)


def planted_labels(g: CSRGraph, cfg: GNNConfig, feat: np.ndarray, *,
                   seed: int = 7) -> np.ndarray:
    """Labels from a frozen random teacher of the same architecture: a
    learnable planted node-classification task for the train driver.  The
    teacher runs the plain PyTorch version (``backend="torch"``) on
    ``cfg.device``; its weights come from ``torch.Generator`` seeded with
    ``seed``, so the labels differ from the reference's for the same seed."""
    teacher = build_gnn(g, dataclasses.replace(cfg, backend="torch"),
                        generator=torch.Generator().manual_seed(seed),
                        reorder="off", tune_iters=2, seed=seed,
                        with_backward=False)
    x = torch.as_tensor(np.asarray(feat, np.float32),
                        device=teacher.executor.device)
    with torch.no_grad():
        out = teacher.logits(teacher.params, x)
    return out.argmax(-1).cpu().numpy()


def make_gnn_train_step(model: GNNModel, opt):
    """The `Trainer`-shaped step of full-graph GNN training.

    opt: an `AdamWConfig`.  Returns ``step_fn(state, batch)`` where state is
    ``(params, opt_state)`` and batch is ``{"feat", "labels"[, "mask"]}``
    (tensors on the model's device, in the plan's node order).  The loss
    and its gradient run through the model's backend; on ``"cuda"`` the
    backward is the transposed-schedule kernels, so the plan must carry
    ``partition_bwd`` (`build_gnn` attaches it).  Metrics are 0-d tensors
    (``loss``, ``accuracy``, ``grad_norm``, ``lr``).
    """
    from repro_torch.optim.adamw import adamw_update

    if model.cfg.backend == "cuda" and model.plan.partition_bwd is None:
        raise ValueError(
            "training on the cuda backend needs a backward schedule: "
            "build the model with with_backward=True")

    def step_fn(state, batch):
        params, opt_state = state
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, metrics = model.loss(leaves, batch["feat"], batch["labels"],
                                   batch.get("mask"))
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        params, opt_state, om = adamw_update(opt, grads, opt_state, params)
        return (params, opt_state), {**{k: v.detach()
                                        for k, v in metrics.items()}, **om}

    return step_fn
