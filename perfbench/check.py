"""The comparisons that decide ``correct``: the port's outputs against
the plain reference, each number beside its limit (`limits/<cell>.json`).

Training (the first steps of the object the window then drives): each
step's loss; the first gradient as AdamW got it, worked out from its
first moment after one step; the parameters' change over the checked
steps.  Gradients and changes are compared by the worst leaf: the gap
between the two norms over the larger of the reference's norm of that
leaf and of the median leaf.  A leaf whose reference gradient is under a
thousandth of the median leaf's is left out of the change.

Inference (sampled requests of the window): each node's logits, as the
widest gap over its row's scale (the larger of its own largest |logit|
and the median row's); and the answer itself, as the widest gap by which
the reference's logit of the class the port returned lies below the
reference's best, on the same scale.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import torch

__all__ = ["infer_numbers", "judge", "leaf_gaps", "train_numbers"]

Checks = Dict[str, Tuple[float, float]]


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Iterable[str]) -> list:
    """Over ``keys``: | |prog_k| - |ref_k| | / max(|ref_k|, median over all
    leaves of |ref|), ascending."""
    rn, pn = _norms(ref), _norms(prog)
    med = sorted(rn.values())[len(rn) // 2]
    return sorted(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def train_numbers(prog_losses: Sequence[float],
                  prog_grad: Dict[str, torch.Tensor],
                  prog_move: Dict[str, torch.Tensor],
                  ref_losses: Sequence[float],
                  ref_grad: Dict[str, torch.Tensor],
                  ref_move: Dict[str, torch.Tensor]) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog_losses, ref_losses))
    rg = _norms(ref_grad)
    med = sorted(rg.values())[len(rg) // 2]
    moved = [k for k in ref_grad if rg[k] >= 1e-3 * med]
    move = leaf_gaps(prog_move, ref_move, moved)
    return {"loss_gap": loss_gap,
            "loss1_gap": abs(prog_losses[0] - ref_losses[0])
            / max(abs(ref_losses[0]), 1e-30),
            "grad_gap": leaf_gaps(prog_grad, ref_grad, list(ref_grad))[-1],
            "move_gap": move[-1],
            "move_median_gap": move[len(move) // 2],
            "leaves_left_out": float(len(ref_grad) - len(moved))}


def infer_numbers(prog_logits: Sequence[torch.Tensor],
                  prog_classes: Sequence[torch.Tensor],
                  ref_logits: torch.Tensor) -> Dict[str, float]:
    """``prog_logits`` and ``prog_classes`` in the reference's node order,
    one of each per sampled request."""
    row = ref_logits.abs().amax(dim=1)
    scale = torch.clamp(row, min=float(row.median()))
    best = ref_logits.amax(dim=1)
    logit_gap = argmax_gap = 0.0
    for lg, cls in zip(prog_logits, prog_classes):
        d = (lg.to(ref_logits.device) - ref_logits).abs().amax(dim=1)
        logit_gap = max(logit_gap, float((d / scale).max()))
        got = ref_logits.gather(1, cls.to(ref_logits.device).long()[:, None])
        argmax_gap = max(argmax_gap, float(((best - got[:, 0]) / scale).max()))
    return {"logit_gap": logit_gap, "argmax_gap": argmax_gap}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Checks]:
    """Every number at or under its limit (a NaN fails)."""
    checks = {k: (numbers[k], float(limits[k])) for k in limits}
    ok = all(not math.isnan(v) and v <= lim for v, lim in checks.values())
    return ok, checks
