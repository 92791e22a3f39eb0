"""The LM forward inside a rank of a mesh: the ``mesh=`` paths of the LM
stack, written out.

Port-only module.  The reference's ``mesh=`` paths
(`src/repro/models/lm.py:135` `make_prefill_step`, :184
`make_decode_step`, `src/repro/nn/transformer.py:320` `lm_forward` with
its `_cx` constraints) leave the compute layout to GSPMD, which derives
it from the parameter specs.  `torch.distributed` has no such
propagation that knows the scan kernel or the MoE's scatters, so the
port writes the layout out, Megatron style, from the same specs.  Every
function here runs inside a rank: ``lp`` is the rank's
`repro_torch.distributed.sharding.Local` slice of the parameters (or of
one layer's), ``mesh`` its `repro_torch.distributed.ranks.AxisGroups`,
and activations are the rank's batch slice.

  * The batch is split over ``(pod, data)``; activations are whole over
    ``model`` between blocks.  Weights whose dims the specs split over
    ``data`` (FSDP) are all-gathered over ``data`` right before their
    layer (`Local.get`).
  * Attention is split over query heads: rank ``r`` of ``model`` takes
    heads ``[r H/tp, (r+1) H/tp)`` and the kv heads they read.  Where
    the decode cache splits kv heads over ``model`` (``n_kv % tp == 0``)
    a rank computes its own ``n_kv / tp`` kv heads; otherwise every rank
    computes all of them (``wk`` / ``wv`` are whole on every rank by the
    default rules: ``kv_heads`` maps to no axis).  A fused ``wqkv`` is
    gathered whole over ``model`` and sliced, since its one ``H + 2K``
    dim does not split at the q / k / v boundaries.  ``wo`` is
    row-parallel: one all-reduce over ``model``.
  * Decode over a cache split by sequence (``n_kv % tp != 0``): every
    rank attends with all H query heads over its slots, and the shards
    combine by log-sum-exp: a max all-reduce of the logits' maxima and
    one sum all-reduce of the numerators and denominators.
  * The GLU / plain MLP is column- then row-parallel: one all-reduce.
  * Mamba is split over ``d_inner``: ``in_proj``, the conv, ``dt_proj``
    and the scan (the hand-written kernel on ``backend="cuda"``) are
    local per channel, ``x_proj`` and ``out_proj`` row-parallel with an
    all-reduce each (`repro_torch.nn.mamba`'s ``reduce``).
  * The embedding and the unembedding are vocab-parallel: a rank looks
    up the ids in its vocab slice and an all-reduce sums the rows (one
    rank holds each); the last-token logits are all-gathered over
    ``model``.
  * The MoE is `repro_torch.nn.moe.moe_apply` with the rank's mesh.

Row-parallel partial sums are all-reduced in the activation dtype, as
the MoE's combine is.  A dim a split needs (heads, ``d_ff``,
``d_inner``, the vocab, the experts) must divide by the model axis, or
the call raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import Local
from repro_torch.nn.attention import (_NEG, AttnParams, _apply_rope, _qkv,
                                      blockwise_attention, decode_attention,
                                      ring_positions)
from repro_torch.nn.layers import apply_glu_mlp
from repro_torch.nn.mamba import mamba_decode, mamba_forward
from repro_torch.nn.moe import moe_apply

__all__ = ["MODEL", "lm_decode_tp", "lm_prefill_tp"]

MODEL = "model"


def _split(n: int, tp: int, what: str) -> int:
    if n % tp:
        raise ValueError(f"{what} {n} does not split over the model axis "
                         f"({tp} ranks)")
    return n // tp


def _model_axes(entry) -> tuple:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in axes if a is not None)


def _kv_layout(spec) -> str:
    """How a stacked (R, B, S, K, hd) KV leaf's spec lays it over
    ``model``:
    ``"heads"`` (kv heads split), ``"seq"`` (sequence split) or
    ``"whole"``."""
    if MODEL in _model_axes(spec[3] if len(spec) > 3 else None):
        return "heads"
    if MODEL in _model_axes(spec[2] if len(spec) > 2 else None):
        return "seq"
    return "whole"


# ---------------------------------------------------------------------------
# embedding, logits, norms

def _embed(cfg, lp: Local, mesh, inputs: torch.Tensor, pos: torch.Tensor
           ) -> torch.Tensor:
    from repro_torch.nn.transformer import _embed_post
    if cfg.frontend == "tokens":
        w = lp.get("embed", MODEL)                          # (V/tp, d)
        ids = inputs.long() - mesh.index(MODEL) * w.shape[0]
        hit = (ids >= 0) & (ids < w.shape[0])
        rows = w[ids.clamp(0, w.shape[0] - 1)].to(cfg.dtype)
        x = mesh.all_reduce(torch.where(hit[..., None], rows, 0), MODEL)
    else:
        x = inputs.to(cfg.dtype)
    return _embed_post(cfg, x, pos)


def _logits(cfg, lp: Local, mesh, last: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings and cfg.frontend == "tokens":
        w = lp.get("embed", MODEL).T
    else:
        w = lp.get("unembed", None, MODEL)
    logits = last.float() @ w.float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return mesh.all_gather(logits, MODEL, dim=-1)


def _norm(cfg, lp: Local, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.nn.transformer import _apply_norm
    return _apply_norm(cfg, lp.full(), x)


# ---------------------------------------------------------------------------
# attention

@dataclasses.dataclass
class _Heads:
    """A rank's attention weights: query heads [hs, hs + Hl), kv heads
    [k0, k1), as a local param dict and its `AttnParams`."""

    p: dict
    ap: AttnParams
    hs: int
    k0: int


def _heads(ap: AttnParams, lp: Local, mesh, *, q_all: bool,
           kv_split: bool) -> _Heads:
    """The rank's attention weights: its query heads (all of them with
    ``q_all``) and its kv heads (its ``K / tp`` with ``kv_split``, else
    all ``K``)."""
    H, K = ap.n_heads, ap.n_kv
    tp, r = mesh.size(MODEL), mesh.index(MODEL)
    Hl = H if q_all else _split(H, tp, "n_heads")
    hs = 0 if q_all else r * Hl
    Kl = _split(K, tp, "n_kv") if kv_split else K
    k0 = r * Kl if kv_split else 0
    if ap.fused_qkv:
        w = lp.get("wqkv")
        p = {"wq": w[:, hs:hs + Hl], "wk": w[:, H + k0:H + k0 + Kl],
             "wv": w[:, H + K + k0:H + K + k0 + Kl]}
    else:
        p = {"wq": lp.get("wq") if q_all else lp.get("wq", None, MODEL),
             "wk": lp.get("wk")[:, k0:k0 + Kl],
             "wv": lp.get("wv")[:, k0:k0 + Kl]}
    if ap.bias:
        p["bq"] = lp.get("bq") if q_all else lp.get("bq", MODEL)
        p["bk"] = lp.get("bk")[k0:k0 + Kl]
        p["bv"] = lp.get("bv")[k0:k0 + Kl]
    if ap.qk_norm:
        p["qnorm"], p["knorm"] = lp.get("qnorm"), lp.get("knorm")
    local = dataclasses.replace(ap, n_heads=Hl, n_kv=Kl, fused_qkv=False)
    return _Heads(p=p, ap=local, hs=hs, k0=k0)


def _row_parallel_wo(ap: AttnParams, lp: Local, mesh, out: torch.Tensor,
                     dtype) -> torch.Tensor:
    """``out`` (B, S, H/tp, hd), the rank's query heads, through ``wo``'s
    rows for those heads, all-reduced over ``model``, plus the bias."""
    wo = lp.get("wo", MODEL)
    y = out.to(dtype).flatten(-2) @ wo.to(dtype).reshape(-1, wo.shape[-1])
    y = mesh.all_reduce(y, MODEL)
    if ap.bias:
        y = y + lp.get("bo").to(dtype)
    return y


def _attention_prefill(cfg, ap: AttnParams, lp: Local, mesh, x, pos,
                       kv_spec):
    """Returns (y (B, S, d), (k, v) in the cache's layout)."""
    layout = _kv_layout(kv_spec)
    hd = _heads(ap, lp, mesh, q_all=False, kv_split=layout == "heads")
    q, k, v = _qkv(hd.p, hd.ap, x)
    q, k = _apply_rope(hd.ap, q, k, pos)
    n_rep = ap.n_heads // ap.n_kv
    Hl = q.shape[2]
    idx = (torch.arange(hd.hs, hd.hs + Hl, device=x.device) // n_rep
           - hd.k0)
    pos1d = pos[0] if ap.rope != "mrope" else pos[0, 0]
    out = blockwise_attention(q, k[:, :, idx], v[:, :, idx], q_pos=pos1d,
                              kv_pos=pos1d, window=ap.window,
                              softcap=ap.softcap, scale=ap.scale,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                              causal_mode=cfg.causal_mode)
    y = _row_parallel_wo(ap, lp, mesh, out, x.dtype)
    if layout == "seq":
        axes = _model_axes(kv_spec[2])
        c = k.shape[1] // mesh.size(axes)
        s0 = mesh.index(axes) * c
        k, v = k[:, s0:s0 + c], v[:, s0:s0 + c]
    return y, (k, v)


def _attention_decode(ap: AttnParams, lp: Local, mesh, x, cache: dict,
                      kv_spec, t: int, pos) -> torch.Tensor:
    """One step over the rank's slice of the layer's cache (written in
    place)."""
    layout = _kv_layout(kv_spec)
    hd = _heads(ap, lp, mesh, q_all=layout != "heads",
                kv_split=layout == "heads")
    q, k, v = _qkv(hd.p, hd.ap, x)
    q, k = _apply_rope(hd.ap, q, k, pos)
    seq_axes = _model_axes(kv_spec[2]) if layout == "seq" else ()
    Sc_l = cache["k"].shape[1]
    Sc = Sc_l * mesh.size(seq_axes)
    c0 = mesh.index(seq_axes) * Sc_l
    slot = t % Sc if ap.window is not None else t
    if c0 <= slot < c0 + Sc_l:
        cache["k"][:, slot - c0] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - c0] = v[:, 0].to(cache["v"].dtype)
    kv_pos = ring_positions(t, Sc, windowed=ap.window is not None,
                            device=x.device)[c0:c0 + Sc_l]
    if layout == "heads":
        out = decode_attention(q, cache["k"], cache["v"], kv_pos, t,
                               scale=ap.scale, softcap=ap.softcap,
                               window=ap.window)
    else:
        out = _decode_attention_split(q, cache["k"], cache["v"], kv_pos, t,
                                      ap, mesh, seq_axes)
        Hl = _split(ap.n_heads, mesh.size(MODEL), "n_heads")
        out = out[:, :, mesh.index(MODEL) * Hl:(mesh.index(MODEL) + 1) * Hl]
    return _row_parallel_wo(ap, lp, mesh, out, x.dtype)


def _decode_attention_split(q, cache_k, cache_v, kv_pos, t: int,
                            ap: AttnParams, mesh, axes) -> torch.Tensor:
    """`decode_attention` over a cache split by sequence over ``axes``:
    each rank's slots give partial sums at the global maximum (one max
    all-reduce), combined by one sum all-reduce.  (B, 1, H, hd) f32."""
    B, _, H, hd = q.shape
    K = cache_k.shape[2]
    qg = q.float().reshape(B, K, H // K, hd)
    logits = torch.einsum("bkrd,bskd->bkrs", qg, cache_k.float()) * ap.scale
    if ap.softcap is not None:
        logits = ap.softcap * torch.tanh(logits / ap.softcap)
    valid = (kv_pos >= 0) & (kv_pos <= t)
    if ap.window is not None:
        valid &= kv_pos > (t - ap.window)
    logits = torch.where(valid, logits, _NEG)
    m = mesh.all_reduce(logits.amax(dim=-1), axes, op="max")
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    acc = torch.cat([torch.einsum("bkrs,bskd->bkrd", p, cache_v.float()),
                     p.sum(dim=-1, keepdim=True)], dim=-1)
    acc = mesh.all_reduce(acc, axes)
    return (acc[..., :hd] / acc[..., hd:]).reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# Mamba, FFN

def _mamba_local(mp, lp: Local, mesh):
    tp = mesh.size(MODEL)
    p = {"in_proj": lp.get("in_proj", None, None, MODEL),
         "conv_w": lp.get("conv_w", None, MODEL),
         "conv_b": lp.get("conv_b", MODEL),
         "x_proj": lp.get("x_proj", MODEL),
         "dt_proj": lp.get("dt_proj", None, MODEL),
         "dt_bias": lp.get("dt_bias", MODEL),
         "A_log": lp.get("A_log", MODEL),
         "D": lp.get("D", MODEL),
         "out_proj": lp.get("out_proj", MODEL)}
    return p, dataclasses.replace(
        mp, d_inner=_split(mp.d_inner, tp, "d_inner"))


def _ffn(cfg, spec, lp: Local, mesh, x: torch.Tensor):
    """The slot's FFN half; returns (x, aux or None)."""
    if spec.mlp == "none":
        return x, None
    aux = None
    h = _norm(cfg, lp["norm2"], x)
    f = lp["ffn"]
    if spec.mlp == "glu":
        h = mesh.all_reduce(apply_glu_mlp(
            {"wi": f.get("wi", None, None, MODEL), "wo": f.get("wo", MODEL)},
            h, act=cfg.activation), MODEL)
    elif spec.mlp == "mlp":
        dt = h.dtype
        u = cfg.activation((h @ f.get("w1", None, MODEL).to(dt)).float()
                           + f.get("b1", MODEL).float())
        h = (mesh.all_reduce(u.to(dt) @ f.get("w2", MODEL).to(dt), MODEL)
             + f.get("b2").to(dt))
    else:
        h, aux, _dropped = moe_apply(f, h, cfg.moe, mesh=mesh)
    if cfg.post_norm:
        h = _norm(cfg, lp["post2"], h)
    return x + h, aux


def _slot_prefill(cfg, spec, lp: Local, mesh, x, pos, *, backend: str,
                  kv_spec):
    h = _norm(cfg, lp["norm1"], x)
    kv = None
    if spec.kind == "attn":
        h, kv = _attention_prefill(cfg, cfg.attn_params(spec), lp["attn"],
                                   mesh, h, pos, kv_spec)
    else:
        p, mp = _mamba_local(cfg.mamba, lp["mamba"], mesh)
        h = mamba_forward(p, h, mp, backend=backend,
                          reduce=lambda t: mesh.all_reduce(t, MODEL))
    if cfg.post_norm:
        h = _norm(cfg, lp["post1"], h)
    x, _aux = _ffn(cfg, spec, lp, mesh, x + h)
    return x, kv


def lm_prefill_tp(lp: Local, cfg, mesh, inputs: torch.Tensor,
                  pos: torch.Tensor, *, backend: str, kv_specs: tuple):
    """`repro_torch.nn.transformer.lm_prefill` on a rank: returns (its
    batch rows' last-token logits (B_l, V) f32, whole over ``model``;
    its slices of ``kvs``, laid out by ``kv_specs``)."""
    x = _embed(cfg, lp, mesh, inputs, pos)
    per_slot = [[] for _ in cfg.period]
    for slots in lp["blocks"]:
        for s, (spec, bp) in enumerate(zip(cfg.period, slots)):
            kv_spec = kv_specs[s][0] if kv_specs[s] is not None else None
            x, kv = _slot_prefill(cfg, spec, bp, mesh, x, pos,
                                  backend=backend, kv_spec=kv_spec)
            per_slot[s].append(kv)
    x = _norm(cfg, lp["final_norm"], x)
    kvs = tuple(None if spec.kind != "attn" else
                tuple(torch.stack(leaf) for leaf in zip(*got))
                for spec, got in zip(cfg.period, per_slot))
    return _logits(cfg, lp, mesh, x[:, -1, :]), kvs


def lm_decode_tp(lp: Local, cfg, mesh, cache: Local, tok: torch.Tensor,
                 t: int) -> torch.Tensor:
    """`repro_torch.nn.transformer.lm_decode_step` on a rank: its batch
    rows' logits (B_l, V) f32; its slice of the cache written in place."""
    t = int(t)
    inp = tok[:, None] if cfg.frontend == "tokens" else tok[:, None, :]
    B = inp.shape[0]
    pos_embed = torch.full((B, 1), t, dtype=torch.int32, device=inp.device)
    pos = (torch.full((B, 3, 1), t, dtype=torch.int32, device=inp.device)
           if cfg.rope == "mrope" else pos_embed)
    x = _embed(cfg, lp, mesh, inp, pos_embed)
    reduce = lambda y: mesh.all_reduce(y, MODEL)  # noqa: E731
    for r, slots in enumerate(lp["blocks"]):
        for s, (spec, bp) in enumerate(zip(cfg.period, slots)):
            layer = {k: v[r] for k, v in cache.tree[s].items()}
            h = _norm(cfg, bp["norm1"], x)
            if spec.kind == "attn":
                h = _attention_decode(cfg.attn_params(spec), bp["attn"], mesh,
                                      h, layer, cache.specs[s]["k"], t, pos)
            else:
                p, mp = _mamba_local(cfg.mamba, bp["mamba"], mesh)
                h, new = mamba_decode(p, h, layer, mp, reduce)
                for k, v in new.items():
                    layer[k].copy_(v)
            if cfg.post_norm:
                h = _norm(cfg, bp["post1"], h)
            x, _aux = _ffn(cfg, spec, bp, mesh, x + h)
    x = _norm(cfg, lp["final_norm"], x)
    return _logits(cfg, lp, mesh, x[:, 0])
