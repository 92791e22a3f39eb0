"""Mixture-of-Experts FFN with fixed-capacity expert bins.

Port of `src/repro/nn/moe.py`: `MoEParams` (:41), `moe_init` (:49),
`_route` (:60), `_expert_ffn` (:75), `_moe_local` (:82) and `moe_apply`
(:126) on one device.  Expert parallelism over a mesh waits for the
sharding slice (ROADMAP Queue 1 item 5): `moe_apply` with a mesh raises.

The Switch / GShard contract, as in the reference: each expert takes at
most C = max(8, ceil(T k cf / E)) of the T tokens' k choices; slots are
handed out by a cumulative count over the (T k) choices in token-major
order, so that order decides which choices drop; a dropped choice adds
nothing.  The router runs in float32 (its weight is float32 whatever
the model's dtype), the experts' projections in the activation dtype
with a SiLU gate (whatever the model's activation) computed in float32
and rounded once, the combine in float32, cast at the end.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import Initializer

__all__ = ["MoEParams", "moe_init", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEParams:
    n_experts: int
    topk: int
    d_ff: int
    capacity_factor: float = 1.25
    router_norm_topk: bool = True   # renormalize selected probs to sum to 1

    def capacity(self, tokens: int) -> int:
        return max(8, int(math.ceil(tokens * self.topk * self.capacity_factor
                                    / self.n_experts)))


def moe_init(init: Initializer, d_model: int, mp: MoEParams) -> dict:
    """``wi`` (E, d, 2, d_ff) takes fan-in 2 (std 0.71) by the reference's
    rule; the router is float32."""
    return {
        "router": init.weight((d_model, mp.n_experts), dtype=torch.float32),
        "wi": init.weight((mp.n_experts, d_model, 2, mp.d_ff)),
        "wo": init.weight((mp.n_experts, mp.d_ff, d_model)),
    }


def _route(router_w, x2d, mp: MoEParams):
    """x2d (T, d) -> (top_idx (T,k), top_w (T,k) f32, (frac, mean_prob),
    probs)."""
    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
    top_w, top_idx = torch.topk(probs, mp.topk, dim=-1)
    if mp.router_norm_topk:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    frac = torch.zeros(mp.n_experts, dtype=torch.float32,
                       device=x2d.device).index_add_(
        0, top_idx.reshape(-1),
        torch.ones(top_idx.numel(), dtype=torch.float32, device=x2d.device))
    frac = frac / (x2d.shape[0] * mp.topk)
    return top_idx, top_w, (frac, probs.mean(dim=0)), probs


def _expert_ffn(wi, wo, buf, act=F.silu):
    """buf (E, C, d) -> (E, C, d) in buf's dtype."""
    E, d, _, f = wi.shape
    h = torch.bmm(buf, wi.to(buf.dtype).reshape(E, d, 2 * f)
                  ).unflatten(-1, (2, f))
    gated = (act(h[:, :, 0].float()) * h[:, :, 1].float()).to(buf.dtype)
    return torch.bmm(gated, wo.to(buf.dtype))


def _moe_local(router_w, wi, wo, x, mp: MoEParams):
    """Dispatch / FFN / combine over all experts.  x (B, S, d).  Returns
    (out (B,S,d), (frac, mean_prob), dropped_frac)."""
    B, S, d = x.shape
    T, k, E = B * S, mp.topk, mp.n_experts
    xf = x.reshape(T, d)
    top_idx, top_w, stats, _ = _route(router_w, xf, mp)
    C = mp.capacity(T)

    flat_e = top_idx.reshape(-1)                         # (T*k,) token-major
    oh = F.one_hot(flat_e, E).to(torch.int32)
    mypos = (torch.cumsum(oh, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = mypos < C

    # scatter one top-k slot at a time; dropped choices add zeros at (0, 0)
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
    zero = torch.zeros_like(flat_e)
    for s in range(k):
        e_s, pos_s, keep_s = flat_e[s::k], mypos[s::k], keep[s::k]
        buf.index_put_(
            (torch.where(keep_s, e_s, zero[s::k]),
             torch.where(keep_s, pos_s, zero[s::k])),
            torch.where(keep_s[:, None], xf, 0).to(x.dtype), accumulate=True)
    y = _expert_ffn(wi, wo, buf)                         # (E, C, d)

    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for s in range(k):
        # a dropped choice reads a clamped slot and weighs it by 0, as the
        # reference's clamped gather does
        contrib = y[flat_e[s::k], mypos[s::k].clamp(max=C - 1)].float()
        out = out + contrib * (top_w[:, s] * keep[s::k])[:, None]
    dropped = 1.0 - keep.sum().float() / (keep.numel() + 1e-9)
    return out.reshape(B, S, d).to(x.dtype), stats, dropped


def moe_apply(p: dict, x: torch.Tensor, mp: MoEParams, *, mesh=None):
    """MoE FFN.  Returns (out (B,S,d), aux_loss, dropped_frac), the last
    two 0-d float32 tensors."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply over a mesh (expert parallelism) is not ported yet "
            "(ROADMAP Queue 1 item 5)")
    out, (frac, mean_prob), dropped = _moe_local(p["router"], p["wi"],
                                                 p["wo"], x, mp)
    return out, mp.n_experts * torch.sum(frac * mean_prob), dropped
