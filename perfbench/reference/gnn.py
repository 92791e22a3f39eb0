"""Plain PyTorch reference of the configurations' models: the
aggregation, masked cross-entropy, gradients and AdamW, in the original
node order of the benchmark's CSR, in whatever float dtype its inputs
have.  Each architecture's forward is its own module (`perfbench/arch/
<arch>.py`, passed in as ``arch``), written from its published equations
with this module's aggregation.  The judge runs it in float64, so that a
number compared is the port's own float32 error and not the reference's:
on full reddit on an H100, GIN's float32 reference itself drifts from
float64 by up to 7% in its third step's loss, where the port stays
within 3e-4.

Written from the published equations, not from the port:
  AdamW (Loshchilov and Hutter): gradients clipped by their global norm
      first, bias-corrected moments, decoupled weight decay on matrices.

The aggregation is an index_add over blocks of edges, so that a block's
gathered rows fit in memory at any width; its gradient is the same sum
over the transposed edges.  `tf32_matmul` stands in for every product in
the control: operands rounded to TF32's 10-bit mantissa, as the tensor
cores round them, with float32 accumulation.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["Adjacency", "adamw_step", "masked_xent", "tf32_matmul",
           "train"]

Params = Dict[str, torch.Tensor]
BLOCK_BYTES = 1 << 30           # gathered rows held at once by one block


class Adjacency:
    """The aggregation operator of one model on one graph.

    ``gcn_norm``: self-loops added and each edge weighted 1 / sqrt(d_u
    d_v) with degrees counted with the self-loop; otherwise the plain
    adjacency, unweighted.  ``rows[k]`` gathers from ``cols[k]``."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, *,
                 gcn_norm: bool, device):
        n = len(indptr) - 1
        deg = np.diff(np.asarray(indptr, np.int64))
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        cols = np.asarray(indices, np.int64)
        vals = None
        if gcn_norm:
            rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
            cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
            d = (deg + 1).astype(np.float64)
            vals = torch.as_tensor(1.0 / np.sqrt(d[rows] * d[cols]),
                                   device=device)
        self.n = n
        self.rows = torch.as_tensor(rows, device=device)
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = vals

    def _sum(self, x: torch.Tensor, dst: torch.Tensor,
             src: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        block = max(1, BLOCK_BYTES // max(1, x.shape[1] * x.element_size()))
        for lo in range(0, len(dst), block):
            hi = min(lo + block, len(dst))
            rows = x.index_select(0, src[lo:hi])
            if self.vals is not None:
                rows = rows * self.vals[lo:hi, None].to(x.dtype)
            out.index_add_(0, dst[lo:hi], rows)
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Aggregate.apply(x, self)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return adj._sum(x, adj.rows, adj.cols)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        return adj._sum(g.contiguous(), adj.cols, adj.rows), None


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_tf32(a) @ _round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ _round_tf32(b).T, _round_tf32(a).T @ g


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product with both operands rounded to TF32."""
    return _TF32MatMul.apply(a, b)


def masked_xent(lg: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Mean over the masked nodes of -log softmax(lg)[label]."""
    per = torch.logsumexp(lg, dim=-1) - lg.gather(1, labels[:, None])[:, 0]
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def adamw_step(opt: dict, params: Params, grads: Params, m: Params,
               v: Params, t: int):
    """One AdamW step (``t`` from 1); returns ``(params, m, v, clipped
    gradient)``, new tensors."""
    keys = sorted(params)
    norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in keys))
    scale = 1.0
    if opt["grad_clip"] is not None:
        scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
    c1 = 1.0 - opt["b1"] ** t
    c2 = 1.0 - opt["b2"] ** t
    new_p, new_m, new_v, clipped = {}, {}, {}, {}
    for k in keys:
        g = grads[k] * scale
        clipped[k] = g
        new_m[k] = opt["b1"] * m[k] + (1 - opt["b1"]) * g
        new_v[k] = opt["b2"] * v[k] + (1 - opt["b2"]) * g * g
        step = (new_m[k] / c1) / (torch.sqrt(new_v[k] / c2) + opt["eps"])
        if params[k].ndim >= 2:
            step = step + opt["weight_decay"] * params[k]
        new_p[k] = params[k] - opt["lr"] * step
    return new_p, new_m, new_v, clipped


def train(arch, model: dict, opt: dict, params: Params, x: torch.Tensor,
          labels: torch.Tensor, mask: torch.Tensor, adj: Adjacency,
          steps: int, matmul: Callable = torch.matmul):
    """``steps`` full-graph AdamW steps from ``params`` of ``model`` (a
    configuration's ``model`` entry), whose forward is ``arch.logits``.

    Returns ``(losses, first_grad, params)``: each step's loss (floats),
    the first step's gradient as AdamW uses it (clipped), and the
    parameters after the last step."""
    p = {k: t.detach().clone() for k, t in params.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses: List[float] = []
    first: Optional[Params] = None
    for t in range(1, steps + 1):
        leaves = {k: q.detach().requires_grad_(True) for k, q in p.items()}
        loss = masked_xent(arch.logits(model, leaves, x, adj, matmul),
                           labels, mask)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        p, m, v, clipped = adamw_step(opt, {k: q.detach() for k, q
                                            in leaves.items()},
                                      grads, m, v, t)
        losses.append(float(loss.detach()))
        if first is None:
            first = clipped
        del loss, grads
    return losses, first, p
