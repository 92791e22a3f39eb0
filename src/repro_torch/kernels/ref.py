"""Plain PyTorch versions of the group-aggregation kernels.

Port of `src/repro/kernels/ref.py` (the aggregation oracles).  These are
the semantic ground truth of the port: small, obviously right, runnable on
any device.  They are what a CPU tensor runs (the CUDA kernels' wrappers
route CPU tensors here) and what `chip_smoke.py` holds each kernel against
on the card.  `group_edge_grad_ref` and the baseline oracles arrive with
the training slice.

Both accumulate in float32 whatever the feature dtype; the schedule
oracle takes ``acc_dtype=torch.float64`` for a near-exact sum, the witness
`chip_smoke.py` holds every float32 sum against.
"""
from __future__ import annotations

import torch

__all__ = ["segment_aggregate_ref", "group_aggregate_ref"]


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
