"""Plain PyTorch versions of the port's kernels.

Port of `src/repro/kernels/ref.py` (the aggregation oracles and
`selective_scan_ref` :24).  These are
the semantic ground truth of the port: small, obviously right, runnable on
any device.  They are what a CPU tensor runs (the CUDA kernels' wrappers
route CPU tensors here) and what `chip_smoke.py` holds each kernel against
on the card.  `group_edge_grad_ref` is the oracle of the edge-value
cotangent (training's backward); `selective_scan_ref` is the Mamba-1
scan's.  `edge_centric_aggregate_ref` (:96) and
`node_centric_aggregate_ref` (:109) are the paper's §5.1 strawmen, the
baselines a benchmark sets beside the planned kernels; no path of the
port calls them.

All accumulate in float32 whatever the feature dtype; every oracle takes ``acc_dtype=torch.float64`` for a near-exact sum, the witness
`chip_smoke.py` holds every float32 sum against.
"""
from __future__ import annotations

import torch

__all__ = ["segment_aggregate_ref", "group_aggregate_ref",
           "group_edge_grad_ref", "selective_scan_ref", "softplus",
           "edge_centric_aggregate_ref", "node_centric_aggregate_ref"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``.

    Not `torch.nn.functional.softplus`, whose ``threshold=20`` returns
    ``x`` unchanged above 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan_ref(xc: torch.Tensor, dt_raw: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                       dt_bias: torch.Tensor, d_skip: torch.Tensor, *,
                       acc_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Oracle of the fused selective scan: the literal per-token Mamba-1
    recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t xc_t B_t``, ``y_t =
    C_t . h_t + D xc_t`` with ``A = -exp(a_log)`` and ``dt =
    softplus(dt_raw + dt_bias)``.

    xc, dt_raw: (B, S, d_inner); b, c: (B, S, N); a_log: (d_inner, N);
    dt_bias, d_skip: (d_inner,).  Returns y (B, S, d_inner) in
    ``acc_dtype``.  The loop carries only the state (B, d_inner, N); the
    reference's (B, S, d_inner, N) discretized tensors never exist."""
    bsz, seq, di = xc.shape
    n = b.shape[-1]
    xc, dt_raw, b, c = (t.to(acc_dtype) for t in (xc, dt_raw, b, c))
    a = -torch.exp(a_log.to(acc_dtype))                        # (di, N)
    dt = softplus(dt_raw + dt_bias.to(acc_dtype))              # (B, S, di)
    dtx = dt * xc
    h = torch.zeros((bsz, di, n), dtype=acc_dtype, device=xc.device)
    y = torch.empty((bsz, seq, di), dtype=acc_dtype, device=xc.device)
    for t in range(seq):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + dtx[:, t, :, None] * b[:, t, None, :])
        y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return y + d_skip.to(acc_dtype) * xc


def segment_aggregate_ref(feat: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, edge_val: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """out[v] = sum_{e: dst_e = v} edge_val_e * feat[src_e]   (float32 accum)."""
    gathered = feat[src.long()].float() * edge_val.float()[:, None]
    out = torch.zeros((num_nodes, feat.shape[1]), dtype=torch.float32,
                      device=feat.device)
    return out.index_add_(0, dst.long(), gathered)


def group_aggregate_ref(feat: torch.Tensor, nbrs: torch.Tensor,
                        edge_val: torch.Tensor, local_node: torch.Tensor,
                        tile_node_block: torch.Tensor, ont: int,
                        out_rows: int, *, max_elems: int = 1 << 28,
                        acc_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Oracle consuming the *group schedule* (same operands as the kernel).

    feat:            (N_src_pad, D)
    nbrs, edge_val:  (T, gpt, gs)
    local_node:      (T, gpt)
    tile_node_block: (T,)
    Returns (out_rows, D) in ``acc_dtype``.  The gather materializes slots
    x columns values, so columns go in chunks of at most
    ``max_elems // slots`` (the function is linear per column; chunking
    changes no sum).
    """
    T, gpt, gs = nbrs.shape
    d = feat.shape[1]
    idx = nbrs.reshape(-1).long()
    ev = edge_val.reshape(-1, 1).to(acc_dtype)
    rows = (tile_node_block.long()[:, None] * ont + local_node.long()).reshape(-1)
    out = torch.zeros((out_rows, d), dtype=acc_dtype, device=feat.device)
    step = max(1, max_elems // max(idx.numel(), 1))
    for c0 in range(0, d, step):
        gathered = feat[idx, c0:c0 + step].to(acc_dtype) * ev
        per_group = gathered.reshape(T * gpt, gs, -1).sum(dim=1)
        out[:, c0:c0 + step].index_add_(0, rows, per_group)
    return out


def group_edge_grad_ref(grad_out: torch.Tensor, feat: torch.Tensor,
                        nbrs: torch.Tensor, local_node: torch.Tensor,
                        tile_node_block: torch.Tensor, ont: int, *,
                        max_elems: int = 1 << 28,
                        acc_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Oracle of the edge-value cotangent: per slot <grad[dst], feat[src]>.

    grad_out:        (out_rows, D) output cotangent (padded rows are zero)
    feat:            (N_src_pad, D)
    nbrs:            (T, gpt, gs) source ids per slot
    local_node:      (T, gpt), tile_node_block: (T,)
    Returns (T, gpt, gs) in ``acc_dtype`` (padded slots carry don't-care
    values).  Columns go in chunks of at most ``max_elems // slots``, as in
    `group_aggregate_ref` (a dot product is a sum over columns, so chunking
    changes no term).
    """
    T, gpt, gs = nbrs.shape
    d = feat.shape[1]
    idx = nbrs.reshape(-1).long()
    rows = (tile_node_block.long()[:, None] * ont + local_node.long()).reshape(-1)
    dots = torch.zeros((T * gpt, gs), dtype=acc_dtype, device=feat.device)
    step = max(1, max_elems // max(idx.numel(), 1))
    for c0 in range(0, d, step):
        fsel = feat[idx, c0:c0 + step].to(acc_dtype).reshape(T * gpt, gs, -1)
        gsel = grad_out[rows, c0:c0 + step].to(acc_dtype)
        dots += (fsel * gsel[:, None, :]).sum(dim=-1)
    return dots.reshape(T, gpt, gs)


def edge_centric_aggregate_ref(feat: torch.Tensor, src: torch.Tensor,
                               dst: torch.Tensor, edge_val: torch.Tensor,
                               num_nodes: int) -> torch.Tensor:
    """Edge-centric baseline (the PyG torch-scatter analogue, Fig. 4c): one
    unit per edge.  The same function as `segment_aggregate_ref`, with
    each pre-scaled message materialized (in the feature dtype) before
    its float32 scatter-add."""
    messages = feat[src.long()] * edge_val[:, None]
    out = torch.zeros((num_nodes, feat.shape[1]), dtype=torch.float32,
                      device=feat.device)
    return out.index_add_(0, dst.long(), messages.float())


def node_centric_aggregate_ref(feat: torch.Tensor, padded_nbrs: torch.Tensor,
                               mask: torch.Tensor,
                               edge_val_padded: torch.Tensor,
                               num_nodes: int) -> torch.Tensor:
    """Node-centric baseline (Fig. 4b): one unit per node, each padded to
    the largest degree, the workload imbalance of Fig. 2b.

    padded_nbrs: (N, max_deg) neighbor ids (0 in the padding)
    mask:        (N, max_deg) 1.0 valid / 0.0 pad
    edge_val_padded: (N, max_deg)
    ``num_nodes`` is the reference's argument, unused there too."""
    gathered = feat[padded_nbrs.long()]                       # (N, deg, D)
    w = (mask * edge_val_padded)[..., None]
    return (gathered * w).sum(dim=1).float()
