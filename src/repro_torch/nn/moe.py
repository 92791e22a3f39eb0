"""Mixture-of-Experts FFN with fixed-capacity expert bins.

Port of `src/repro/nn/moe.py`: `MoEParams` (:41), `moe_init` (:49),
`_route` (:60), `_expert_ffn` (:75), `_moe_local` (:82) and `moe_apply`
(:126), with expert parallelism over a mesh (`moe_apply(mesh=)`).

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
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import Initializer
from repro_torch.nn.layers import PartitionSpec as P

__all__ = ["MoEParams", "moe_init", "moe_axes", "moe_apply",
           "moe_param_specs"]


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


def moe_axes(mp: MoEParams) -> dict:
    """Logical axes of `moe_init`'s leaves: experts over "experts" (EP),
    the model dim of each expert over "expert_mlp" (FSDP)."""
    return {"router": ("embed", None),
            "wi": ("experts", "expert_mlp", None, "mlp"),
            "wo": ("experts", "mlp", "expert_mlp")}


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


def _moe_local(router_w, wi, wo, x, mp: MoEParams, *, e_offset: int = 0,
               e_local: int = None):
    """Dispatch / FFN / combine for the experts ``[e_offset, e_offset +
    e_local)`` (all of them by default; ``wi`` / ``wo`` hold just those).
    x (B, S, d).  Returns (partial out (B,S,d), (frac, mean_prob),
    dropped_frac); the aux loss is assembled by the caller, so that the
    sharded path can average the statistics over the ranks first."""
    B, S, d = x.shape
    T, k = B * S, mp.topk
    e_local = mp.n_experts if e_local is None else e_local
    xf = x.reshape(T, d)
    top_idx, top_w, stats, _ = _route(router_w, xf, mp)
    C = mp.capacity(T)

    le = top_idx.reshape(-1) - e_offset          # (T*k,) token-major
    valid = (le >= 0) & (le < e_local)
    le = torch.where(valid, le, 0)
    # one-hot written out: `F.one_hot` takes other ops on fake tensors
    # than on real ones, and the dry-run traces this path
    oh = ((le[:, None] == torch.arange(e_local, device=le.device))
          & valid[:, None]).to(torch.int32)
    mypos = (torch.cumsum(oh, dim=0) - 1).gather(1, le[:, None])[:, 0]
    keep = valid & (mypos < C)

    # scatter one top-k slot at a time; dropped choices add zeros at (0, 0)
    buf = torch.zeros((e_local, C, d), dtype=x.dtype, device=x.device)
    zero = torch.zeros_like(le)
    for s in range(k):
        e_s, pos_s, keep_s = le[s::k], mypos[s::k], keep[s::k]
        buf.index_put_(
            (torch.where(keep_s, e_s, zero[s::k]),
             torch.where(keep_s, pos_s, zero[s::k])),
            torch.where(keep_s[:, None], xf, 0).to(x.dtype), accumulate=True)
    y = _expert_ffn(wi, wo, buf)                         # (E_loc, C, d)

    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for s in range(k):
        # a dropped or foreign choice reads a clamped slot and weighs it
        # by 0, as the reference's clamped gather does
        contrib = y[le[s::k], mypos[s::k].clamp(0, C - 1)].float()
        out = out + contrib * (top_w[:, s] * keep[s::k])[:, None]
    dropped = 1.0 - keep.sum().float() / (valid.sum().float() + 1e-9)
    return out.reshape(B, S, d).to(x.dtype), stats, dropped


def _moe_ranks(p, x, mp: MoEParams, *, mesh, batch_axes, ep_axis,
               combine=None):
    """Inside a rank (``mesh`` its `AxisGroups`, ``p`` its `Local` slice
    of the MoE parameters, ``x`` its batch slice): expert parallelism
    over ``ep_axis``.  ``combine`` ends the layer (default: the sum over
    ``ep_axis``; sequence parallelism passes its reduce-scatter).

    Gradients (`repro_torch.distributed.ranks`' convention): ``x`` comes
    in as the caller's copy into the layer (its gradient is summed over
    ``ep_axis`` there); the router is read whole by every rank but
    weighs only the rank's experts, so it enters by `copy_to`; the
    combine and the statistics' sum have the identity backward, so
    each rank's share of the aux loss's gradient flows through its own
    statistics and the router's gradient includes the aux term."""
    from repro_torch.distributed.ranks import copy_to, reduce_from
    tp = mesh.size(ep_axis)
    if mp.n_experts % tp:
        raise ValueError(f"{mp.n_experts} experts do not split over "
                         f"{ep_axis} ({tp} ranks)")
    e_local = mp.n_experts // tp
    # the FSDP unshard: every dim but the experts' whole (all-gathers
    # over the axes the stored specs split them over: the FSDP axis)
    router_w = copy_to(p.get("router"), mesh, ep_axis)
    wi = p.get("wi", ep_axis)
    wo = p.get("wo", ep_axis)
    out, (frac, mean_prob), dropped = _moe_local(
        router_w, wi, wo, x, mp, e_offset=mesh.index(ep_axis) * e_local,
        e_local=e_local)
    # combine in the activation dtype: each token's partials come from at
    # most topk ranks
    out = (reduce_from(out, mesh, ep_axis) if combine is None
           else combine(out))
    # exact layout-invariant aux: average the routing statistics over all
    # ranks (model ranks see identical stats, batch ranks partition the
    # tokens), then form E * sum(frac * mean_prob)
    axes = tuple(a for a in batch_axes if a in mesh.shape) + (ep_axis,)
    n = mesh.size(axes)
    flat = reduce_from(torch.cat([frac, mean_prob, dropped.reshape(1)]),
                       mesh, axes) / n
    E = mp.n_experts
    aux = E * torch.sum(flat[:E] * flat[E:2 * E])
    return out, aux, flat[2 * E].detach()


def _r_moe(r, mesh_key: str, key: str, mp: MoEParams, x_w, batch_axes,
           ep_axis):
    from repro_torch.device import set_matmul_precision
    from repro_torch.distributed.ranks import from_wire, to_wire
    from repro_torch.distributed.sharding import constrain
    set_matmul_precision()
    mesh = r.state[mesh_key]
    x = constrain(from_wire(x_w, r.device), mesh,
                  P(tuple(a for a in batch_axes if a in mesh.shape)))
    with torch.no_grad():
        out, aux, dropped = _moe_ranks(
            r.state[key], x, mp, mesh=mesh, batch_axes=batch_axes,
            ep_axis=ep_axis)
    return to_wire(out), float(aux), float(dropped)


def moe_param_specs(mp: MoEParams, *, ep_axis: str = "model",
                    fsdp_axis: Optional[str] = "data") -> dict:
    """The layout `moe_apply` lays a whole parameter dict out by on a
    mesh (the reference's ``shard_map`` in-specs)."""
    return {"router": P(fsdp_axis, None),
            "wi": P(ep_axis, fsdp_axis, None, None),
            "wo": P(ep_axis, None, fsdp_axis)}


def moe_apply(p, x: torch.Tensor, mp: MoEParams, *, mesh=None,
              batch_axes=("pod", "data"), ep_axis: str = "model",
              fsdp_axis: Optional[str] = "data"):
    """MoE FFN.  Returns (out (B,S,d), aux_loss, dropped_frac).

    Without a mesh (or with one that has no ``ep_axis``): one device,
    all experts, the last two 0-d float32 tensors.  With a mesh, expert
    parallelism over ``ep_axis``:

      * from a caller (``mesh`` a `repro_torch.launch.mesh.Mesh`): ``p``
        is a whole parameter dict, laid out here by `moe_param_specs`,
        or a `repro_torch.runtime.elastic.ShardedTree` of it; ``x`` is
        the whole batch, split over ``batch_axes``; the output comes
        back whole on ``x``'s device, aux and dropped as floats;
      * inside a rank (``mesh`` its `AxisGroups`): ``p`` is the rank's
        `Local` slice, ``x`` its batch slice; the slice's own specs say
        which dims to gather (``fsdp_axis`` is not read).

    Activations are replicated over ``ep_axis``, so every model rank
    routes its tokens identically and keeps only its ``E / tp`` experts
    (a capacity of its own, counted over its T_local tokens); the
    router, ``wi`` and ``wo`` are gathered whole but for the experts'
    dim; the combine is one all-reduce over ``ep_axis`` in the
    activation dtype; frac, mean_prob and dropped are averaged over
    every axis before the aux loss is formed, so it does not depend on
    the layout."""
    if mesh is None or ep_axis not in mesh.axis_names:
        out, (frac, mean_prob), dropped = _moe_local(p["router"], p["wi"],
                                                     p["wo"], x, mp)
        return out, mp.n_experts * torch.sum(frac * mean_prob), dropped
    from repro_torch.distributed.ranks import AxisGroups
    if isinstance(mesh, AxisGroups):
        return _moe_ranks(p, x, mp, mesh=mesh, batch_axes=batch_axes,
                          ep_axis=ep_axis)
    from repro_torch.distributed.ranks import from_wire, to_wire
    from repro_torch.distributed.sharding import join_batch
    from repro_torch.runtime.elastic import ShardedTree, reshard
    tp = mesh.shape[ep_axis]
    if mp.n_experts % tp:
        raise ValueError(f"{mp.n_experts} experts do not split over "
                         f"{ep_axis} ({tp} ranks)")
    if not isinstance(p, ShardedTree):
        p = reshard(p, mesh, moe_param_specs(mp, ep_axis=ep_axis,
                                             fsdp_axis=fsdp_axis))
    got = mesh.group.run(_r_moe, None, mesh.key, p.key, mp, to_wire(x),
                         tuple(batch_axes), ep_axis)
    out = join_batch(mesh, batch_axes, [from_wire(g[0], x.device)
                                        for g in got], x.shape[0])
    return out, got[0][1], got[0][2]

