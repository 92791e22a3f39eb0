"""The LM inside a rank of a mesh: the ``mesh=`` paths of the LM stack,
written out, forward and backward.

Port-only module.  The reference's ``mesh=`` paths
(`src/repro/models/lm.py:84` `make_train_step`, :135
`make_prefill_step`, :184 `make_decode_step`,
`src/repro/nn/transformer.py:320` `lm_forward` with its `_cx`
constraints) leave the compute layout to GSPMD, which derives it from
the parameter specs.  `torch.distributed` has no such propagation that
knows the scan kernel or the MoE's scatters, so the port writes the
layout out, Megatron style, from the same specs.  Every function here
runs inside a rank: ``lp`` is the rank's
`repro_torch.distributed.sharding.Local` slice of the parameters (or of
one layer's), ``mesh`` its `repro_torch.distributed.ranks.AxisGroups`,
and activations are the rank's batch slice.

  * The batch is split over ``(pod, data)``; activations are whole over
    ``model`` between blocks (the "carry"), or, in training with
    ``seq_shard_carry``, split over the sequence on ``model`` (Megatron
    sequence parallelism: a reduce-scatter along S ends each
    row-parallel layer in place of the all-reduce, and an all-gather
    along S comes after the next norm, before the column-parallel
    layer; the reference's ``_cx(seq_shard=True)``).  Weights whose dims
    the specs split over ``data`` (FSDP) are all-gathered over ``data``
    right before their layer (`Local.get`).
  * Attention is split over query heads: rank ``r`` of ``model`` takes
    heads ``[r H/tp, (r+1) H/tp)`` and the kv heads they read.  Where
    the decode cache splits kv heads over ``model`` (``n_kv % tp == 0``;
    in training where ``n_kv % tp == 0``) a rank computes its own
    ``n_kv / tp`` kv heads; otherwise every rank computes all of them
    (``wk`` / ``wv`` are whole on every rank by the default rules:
    ``kv_heads`` maps to no axis).  A fused ``wqkv`` is gathered whole
    over ``model`` and sliced, since its one ``H + 2K`` dim does not
    split at the q / k / v boundaries.  ``wo`` is row-parallel: one
    all-reduce over ``model``.
  * Attention replicated over ``model``: where the pruned specs keep no
    ``model`` axis on the query heads (`valid_spec` drops it when the
    model axis does not divide them: gemma2-2b's 8 and qwen2-vl-2b's 12
    heads on 16), every model rank computes all H query heads and all
    K kv heads with ``wo`` whole, and no sum over ``model`` follows, as
    GSPMD runs the reference's attention there (`_replicated`).  On a
    whole carry each rank's input and weight gradients are then whole
    (nothing summed); on a sequence-split carry a rank gathers the
    sequence, keeps its own tokens of the output, and its weight
    gradients are partial (summed).
  * Decode over a cache split by sequence (``n_kv % tp != 0``): every
    rank attends with all H query heads over its slots, and the shards
    combine by log-sum-exp: a max all-reduce of the logits' maxima and
    one sum all-reduce of the numerators and denominators.
  * The GLU / plain MLP is column- then row-parallel: one all-reduce.
  * Mamba is split over ``d_inner``: ``in_proj``, the conv, ``dt_proj``
    and the scan (the hand-written kernel on ``backend="cuda"``; the
    chunked path in training) are local per channel, ``x_proj`` and
    ``out_proj`` row-parallel with an all-reduce each
    (`repro_torch.nn.mamba`'s ``reduce_ssm`` and ``reduce``).
  * The embedding and the unembedding are vocab-parallel: a rank looks
    up the ids in its vocab slice and an all-reduce sums the rows (one
    rank holds each); the last-token logits are all-gathered over
    ``model``; the training loss is
    `repro_torch.nn.losses.vocab_parallel_xent_sums` over the rank's
    vocab slice, with no logits gathered.
  * The FFN, the Mamba mixer and the vocabulary replicated over
    ``model``: each is decided on its own, from the pruned spec of its
    dim (`_whole`: ``d_ff`` from ``wi``'s dim 2 or ``w1``'s dim 1,
    ``d_inner`` from ``in_proj``'s dim 2, the vocabulary from
    ``embed``'s dim 0 or ``unembed``'s dim 1).  Where `valid_spec`
    dropped the ``model`` axis there (Falcon-Mamba-7B's d_inner 8192 and
    V 65024 on a model axis of 3), every model rank computes that part
    whole, as GSPMD runs the reference: the input through
    `_Carry.gather`, the weights whole through `_Carry.leaf`, the output
    onto the carry through `_Carry.keep`, no sum over ``model``.  The
    Mamba mixer then scans all ``d_inner`` channels on every rank and
    its decode state is whole; the embedding looks up the carry's own
    tokens in the whole table; the logits need no gather; the loss is
    `repro_torch.nn.losses.chunked_xent_sums` over the whole vocabulary
    on every rank, its input taken through `_Carry.share`.
  * The MoE is `repro_torch.nn.moe`'s expert-parallel path on the rank's
    mesh.

Gradients follow `repro_torch.distributed.ranks`' convention: the
collectives above are its differentiable ones (`_Carry` holds the ways
a layer meets the carry), so the same code serves prefill and
decode under `torch.no_grad()` and training under autograd, and a
remat'd period re-issues its collectives in the backward in the order
of its forward, the same on every rank.

Row-parallel partial sums are all-reduced in the activation dtype, as
the MoE's combine is.  Heads, ``d_ff``, ``d_inner`` and the vocabulary
fall back to replication where the model axis does not divide them; the
expert count must divide by it (`repro_torch.nn.moe` refuses otherwise,
as the reference asserts), and `_split` refuses a dim that must split
and does not.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.distributed.ranks import (copy_to, gather_from, reduce_from,
                                           scatter_to)
from repro_torch.distributed.sharding import Local, batch_axes_for
from repro_torch.nn.attention import (_NEG, AttnParams, _apply_rope, _qkv,
                                      blockwise_attention, decode_attention,
                                      ring_positions)
from repro_torch.nn.layers import apply_glu_mlp
from repro_torch.nn.losses import chunked_xent_sums, vocab_parallel_xent_sums
from repro_torch.nn.mamba import mamba_decode, mamba_forward
from repro_torch.nn.moe import _moe_ranks

__all__ = ["MODEL", "lm_decode_tp", "lm_forward_tp", "lm_loss_tp",
           "lm_prefill_tp"]

MODEL = "model"


def _split(n: int, tp: int, what: str) -> int:
    if n % tp:
        raise ValueError(f"{what} {n} does not split over the model axis "
                         f"({tp} ranks)")
    return n // tp


def _model_axes(entry) -> tuple:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in axes if a is not None)


def _whole(lp: Local, key: str, dim: int) -> bool:
    """Whether the pruned spec of leaf ``key`` keeps no ``model`` axis on
    dim ``dim`` (`valid_spec` drops it where the model axis does not
    divide the dim): every model rank then computes that part whole."""
    spec = lp.specs[key]
    return MODEL not in _model_axes(spec[dim] if dim < len(spec) else None)


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


@dataclasses.dataclass
class _Carry:
    """How the residual stream lies on ``model`` between layers: whole on
    every model rank, or (``seq``) split over the sequence (dim 1)."""

    mesh: object
    seq: bool = False

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """``h`` (from the carry) as a layer whose model ranks each
        compute a part takes it: whole, its gradient summed."""
        if self.seq:
            return gather_from(h, self.mesh, MODEL, 1, sum_grad=(MODEL,))
        return copy_to(h, self.mesh, MODEL)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """A layer's partial sums ``y`` (B, S, d) back onto the carry."""
        if self.seq:
            return scatter_to(y, self.mesh, MODEL, 1)
        return reduce_from(y, self.mesh, MODEL)

    def leaf(self, t: torch.Tensor) -> torch.Tensor:
        """A leaf read on the carry (norm gains, output biases, the
        weights of replicated attention): on a split carry each rank
        reads it for its tokens alone."""
        return copy_to(t, self.mesh, MODEL) if self.seq else t

    def gather(self, h: torch.Tensor) -> torch.Tensor:
        """``h`` whole for a layer every model rank computes whole: on a
        split carry the sequence gathered (its gradient reduce-scattered:
        each rank's part is that of its own tokens' outputs), on a whole
        one ``h`` as it is (its gradient is whole on every rank)."""
        if self.seq:
            return gather_from(h, self.mesh, MODEL, 1, sum_grad=(MODEL,))
        return h

    def keep(self, y: torch.Tensor) -> torch.Tensor:
        """A whole layer output ``y`` (B, S, d) back onto the carry, with
        no sum: a split carry keeps the rank's tokens."""
        return self.mesh.chunk(y, MODEL, 1) if self.seq else y

    def share(self, h: torch.Tensor) -> torch.Tensor:
        """``h`` whole for a result every model rank computes whole and
        holds whole (the loss over a whole vocabulary): on a split carry
        the sequence gathered, its gradient this rank's slice of the
        whole one (nothing summed); on a whole one ``h`` as it is."""
        return gather_from(h, self.mesh, MODEL, 1) if self.seq else h

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` along its sequence ``dim``, for the carry's tokens."""
        return self.mesh.chunk(t, MODEL, dim) if self.seq else t

    def positions(self, pos: torch.Tensor) -> torch.Tensor:
        """``pos`` (B, S) or (B, 3, S) for the carry's tokens."""
        return self.own(pos, pos.dim() - 1)


# ---------------------------------------------------------------------------
# embedding, logits, norms

def _embed(cfg, lp: Local, mesh, carry: _Carry, inputs: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """The carry's embeddings.  A vocab-parallel table: the rank's rows
    looked up for every token, summed over ``model``; a whole one
    (`_whole`): the carry's own tokens looked up, no sum."""
    from repro_torch.nn.transformer import _embed_post
    if cfg.frontend == "tokens" and _whole(lp, "embed", 0):
        w = carry.leaf(lp.get("embed"))                     # (V, d)
        x = w[carry.own(inputs, 1).long()].to(cfg.dtype)
    elif cfg.frontend == "tokens":
        w = lp.get("embed", MODEL)                          # (V/tp, d)
        ids = inputs.long() - mesh.index(MODEL) * w.shape[0]
        hit = (ids >= 0) & (ids < w.shape[0])
        rows = w[ids.clamp(0, w.shape[0] - 1)].to(cfg.dtype)
        x = carry.exit(torch.where(hit[..., None], rows, 0))
    else:
        x = carry.own(inputs.to(cfg.dtype), 1)
    return _embed_post(cfg, x, carry.positions(pos))


def _tied(cfg) -> bool:
    return cfg.tie_embeddings and cfg.frontend == "tokens"


def _unembed_whole(cfg, lp: Local) -> bool:
    """Whether the pruned spec keeps no ``model`` axis on the
    unembedding's vocabulary (`_whole`; ``embed``'s when tied)."""
    return (_whole(lp, "embed", 0) if _tied(cfg)
            else _whole(lp, "unembed", 1))


def _unembed(cfg, lp: Local) -> tuple:
    """The rank's unembedding and whether it is whole: (d, V/tp), its
    vocab slice, or (d, V) (`_unembed_whole`); ``embed.T`` when tied."""
    whole = _unembed_whole(cfg, lp)
    if _tied(cfg):
        return (lp.get("embed") if whole else lp.get("embed", MODEL)).T, whole
    return (lp.get("unembed") if whole
            else lp.get("unembed", None, MODEL)), whole


def _logits(cfg, lp: Local, mesh, last: torch.Tensor) -> torch.Tensor:
    """The last token's logits (B, V) f32, whole over ``model``: the
    vocab slices' all-gathered, or a whole unembedding's as they are."""
    w, whole = _unembed(cfg, lp)
    logits = last.float() @ w.float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits if whole else mesh.all_gather(logits, MODEL, dim=-1)


def _norm(cfg, lp: Local, x: torch.Tensor, carry: _Carry) -> torch.Tensor:
    from repro_torch.nn.transformer import _apply_norm
    return _apply_norm(cfg, {k: carry.leaf(v) for k, v in lp.full().items()},
                       x)


# ---------------------------------------------------------------------------
# attention

def _replicated(lp: Local) -> bool:
    """Whether every model rank computes the layer's attention whole: the
    pruned spec of its query heads keeps no ``model`` axis (`valid_spec`
    drops it where the model axis does not divide them).  The heads dim
    is ``wq``'s dim 1, or ``wo``'s dim 0 beside a fused ``wqkv``, whose
    one ``H + 2K`` dim can divide where ``H`` does not (gemma2-2b's 16
    on 16)."""
    return _whole(lp, "wq", 1) if "wq" in lp.specs else _whole(lp, "wo", 0)


@dataclasses.dataclass
class _Heads:
    """A rank's attention weights: query heads [hs, hs + Hl), kv heads
    [k0, k1), as a local param dict and its `AttnParams`; ``replicated``
    when they are all of them on every model rank (`_replicated`)."""

    p: dict
    ap: AttnParams
    hs: int
    k0: int
    replicated: bool


def _heads(ap: AttnParams, lp: Local, mesh, carry: _Carry, *, q_all: bool,
           kv_split: bool) -> _Heads:
    """The rank's attention weights: its query heads (all of them with
    ``q_all``) and its kv heads (its ``K / tp`` with ``kv_split``, else
    all ``K``).  Leaves every model rank holds whole but reads in part
    enter by `copy_to` (their gradients are summed over ``model``).
    Replicated attention takes every head and every weight whole, read
    as the carry reads a leaf (`_Carry.leaf`)."""
    H, K = ap.n_heads, ap.n_kv
    tp, r = mesh.size(MODEL), mesh.index(MODEL)
    rep = _replicated(lp)
    if rep:
        Hl, hs, Kl, k0 = H, 0, K, 0
        part = carry.leaf
    else:
        Hl = H if q_all else _split(H, tp, "n_heads")
        hs = 0 if q_all else r * Hl
        Kl = _split(K, tp, "n_kv") if kv_split else K
        k0 = r * Kl if kv_split else 0
        part = lambda t: copy_to(t, mesh, MODEL)  # noqa: E731
    q_whole = q_all or rep
    if ap.fused_qkv:
        w = part(lp.get("wqkv"))
        p = {"wq": w[:, hs:hs + Hl], "wk": w[:, H + k0:H + k0 + Kl],
             "wv": w[:, H + K + k0:H + K + k0 + Kl]}
    else:
        p = {"wq": part(lp.get("wq")) if q_whole
             else lp.get("wq", None, MODEL),
             "wk": part(lp.get("wk"))[:, k0:k0 + Kl],
             "wv": part(lp.get("wv"))[:, k0:k0 + Kl]}
    if ap.bias:
        p["bq"] = part(lp.get("bq")) if q_whole else lp.get("bq", MODEL)
        p["bk"] = part(lp.get("bk"))[k0:k0 + Kl]
        p["bv"] = part(lp.get("bv"))[k0:k0 + Kl]
    if ap.qk_norm:
        p["qnorm"], p["knorm"] = part(lp.get("qnorm")), part(lp.get("knorm"))
    local = dataclasses.replace(ap, n_heads=Hl, n_kv=Kl, fused_qkv=False)
    return _Heads(p=p, ap=local, hs=hs, k0=k0, replicated=rep)


def _attention_out(ap: AttnParams, lp: Local, carry: _Carry,
                   out: torch.Tensor, dtype, replicated: bool
                   ) -> torch.Tensor:
    """``out`` (B, S, H_l, hd), the rank's query heads, through ``wo``
    onto the carry, plus the bias.  Split heads: ``wo``'s rows for those
    heads, summed over ``model`` (row-parallel).  Replicated: ``wo``
    whole, no sum; a split carry keeps the rank's tokens."""
    wo = carry.leaf(lp.get("wo")) if replicated else lp.get("wo", MODEL)
    y = out.to(dtype).flatten(-2) @ wo.to(dtype).reshape(-1, wo.shape[-1])
    y = carry.keep(y) if replicated else carry.exit(y)
    if ap.bias:
        y = y + carry.leaf(lp.get("bo")).to(dtype)
    return y


def _attention(cfg, ap: AttnParams, lp: Local, mesh, carry: _Carry, h, pos,
               *, kv_split: bool):
    """The attention half of a slot: ``h`` (the normed carry) in, the
    rank's query heads over the whole sequence, the output back on the
    carry.  Returns (y on the carry, k, v (B, S, K_l, hd): the rank's kv
    heads, all K when replicated)."""
    hd = _heads(ap, lp, mesh, carry, q_all=False, kv_split=kv_split)
    x = carry.gather(h) if hd.replicated else carry.enter(h)
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
    return _attention_out(ap, lp, carry, out, h.dtype, hd.replicated), k, v


def _no_head_split_cache(lp: Local, layout: str) -> None:
    """Replicated attention computes every kv head, which a cache split
    over kv heads cannot take (the default specs never pair the two:
    heads the model axis does not divide have kv heads it does not
    divide)."""
    if layout == "heads" and _replicated(lp):
        raise ValueError("attention replicated over the model axis needs a "
                         "kv cache that is not split over kv heads")


def _attention_decode(ap: AttnParams, lp: Local, mesh, x, cache: dict,
                      kv_spec, t: int, pos) -> torch.Tensor:
    """One step over the rank's slice of the layer's cache (written in
    place)."""
    layout = _kv_layout(kv_spec)
    _no_head_split_cache(lp, layout)
    carry = _Carry(mesh)
    hd = _heads(ap, lp, mesh, carry, q_all=layout != "heads",
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
        if not hd.replicated:
            Hl = _split(ap.n_heads, mesh.size(MODEL), "n_heads")
            r = mesh.index(MODEL)
            out = out[:, :, r * Hl:(r + 1) * Hl]
    return _attention_out(ap, lp, carry, out, x.dtype, hd.replicated)


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

def _same(t: torch.Tensor) -> torch.Tensor:
    return t


# the dims of the Mamba mixer's leaves split over ``model`` by d_inner
_MAMBA_SPLIT = {"in_proj": (None, None, MODEL), "conv_w": (None, MODEL),
                "conv_b": (MODEL,), "x_proj": (MODEL,),
                "dt_proj": (None, MODEL), "dt_bias": (MODEL,),
                "A_log": (MODEL,), "D": (MODEL,), "out_proj": (MODEL,)}


def _mamba_local(mp, lp: Local, mesh, carry: _Carry):
    """The rank's Mamba weights and widths, and whether they are whole:
    its ``d_inner`` channels, or all of them, read as the carry reads a
    leaf, where the pruned spec keeps no ``model`` axis on ``d_inner``
    (`_whole`)."""
    if _whole(lp, "in_proj", 2):
        return {k: carry.leaf(lp.get(k)) for k in _MAMBA_SPLIT}, mp, True
    p = {k: lp.get(k, *want) for k, want in _MAMBA_SPLIT.items()}
    return p, dataclasses.replace(
        mp, d_inner=_split(mp.d_inner, mesh.size(MODEL), "d_inner")), False


def _mamba(cfg, lp: Local, mesh, carry: _Carry, h: torch.Tensor, *,
           backend: str) -> torch.Tensor:
    """The Mamba mixer on the normed carry ``h``, over the whole
    sequence.  Split: the rank's ``d_inner`` channels; the ``x_proj`` sum
    is read whole in every rank's channels, so its gradient is summed
    too.  Whole: every channel on every model rank, no sum; a split
    carry keeps the rank's tokens."""
    p, mp, whole = _mamba_local(cfg.mamba, lp, mesh, carry)
    if whole:
        return mamba_forward(p, carry.gather(h), mp, backend=backend,
                             reduce=carry.keep, reduce_ssm=_same)
    return mamba_forward(
        p, carry.enter(h), mp, backend=backend, reduce=carry.exit,
        reduce_ssm=lambda t: copy_to(reduce_from(t, mesh, MODEL), mesh,
                                     MODEL))


# the dims of the dense FFN's leaves split over ``model`` by d_ff (column-
# then row-parallel); ``b2`` is read on the carry either way
_FFN_SPLIT = {"wi": (None, None, MODEL), "wo": (MODEL,), "w1": (None, MODEL),
              "b1": (MODEL,), "w2": (MODEL,)}


def _dense_ffn(cfg, mlp: str, f: Local, carry: _Carry,
               h: torch.Tensor) -> torch.Tensor:
    """The GLU or plain MLP on the normed carry ``h``, its output on the
    carry.  Split: column- then row-parallel, one sum over ``model``.
    Whole (the pruned spec keeps no ``model`` axis on ``d_ff``:
    `_whole`): every model rank computes it whole, no sum; a split carry
    keeps the rank's tokens."""
    if _whole(f, *(("wi", 2) if mlp == "glu" else ("w1", 1))):
        x, out = carry.gather(h), carry.keep
        w = {k: carry.leaf(f.get(k)) for k in _FFN_SPLIT if k in f.tree}
    else:
        x, out = carry.enter(h), carry.exit
        w = {k: f.get(k, *want) for k, want in _FFN_SPLIT.items()
             if k in f.tree}
    if mlp == "glu":
        return out(apply_glu_mlp(w, x, act=cfg.activation))
    dt = x.dtype
    u = cfg.activation((x @ w["w1"].to(dt)).float() + w["b1"].float())
    return (out(u.to(dt) @ w["w2"].to(dt))
            + carry.leaf(f.get("b2")).to(dt))


def _ffn(cfg, spec, lp: Local, mesh, carry: _Carry, x: torch.Tensor):
    """The slot's FFN half; returns (x, aux or None)."""
    if spec.mlp == "none":
        return x, None
    aux = None
    h = _norm(cfg, lp["norm2"], x, carry)
    f = lp["ffn"]
    if spec.mlp in ("glu", "mlp"):
        h = _dense_ffn(cfg, spec.mlp, f, carry, h)
    else:
        h, aux, _dropped = _moe_ranks(f, carry.enter(h), cfg.moe,
                                      mesh=mesh, batch_axes=("pod", "data"),
                                      ep_axis=MODEL, combine=carry.exit)
    if cfg.post_norm:
        h = _norm(cfg, lp["post2"], h, carry)
    return x + h, aux


def _slot(cfg, spec, lp: Local, mesh, carry: _Carry, x, pos, *,
          backend: str, kv_split: bool):
    """One layer on the carry.  Returns (x, aux or None, (k, v) or None:
    the attention slot's keys and values, the rank's kv heads)."""
    h = _norm(cfg, lp["norm1"], x, carry)
    kv = None
    if spec.kind == "attn":
        h, k, v = _attention(cfg, cfg.attn_params(spec), lp["attn"], mesh,
                             carry, h, pos, kv_split=kv_split)
        kv = (k, v)
    else:
        h = _mamba(cfg, lp["mamba"], mesh, carry, h, backend=backend)
    if cfg.post_norm:
        h = _norm(cfg, lp["post1"], h, carry)
    x, aux = _ffn(cfg, spec, lp, mesh, carry, x + h)
    return x, aux, kv


def lm_prefill_tp(lp: Local, cfg, mesh, inputs: torch.Tensor,
                  pos: torch.Tensor, *, backend: str, kv_specs: tuple):
    """`repro_torch.nn.transformer.lm_prefill` on a rank: returns (its
    batch rows' last-token logits (B_l, V) f32, whole over ``model``;
    its slices of ``kvs``, laid out by ``kv_specs``)."""
    carry = _Carry(mesh)
    x = _embed(cfg, lp, mesh, carry, inputs, pos)
    per_slot = [[] for _ in cfg.period]
    for slots in lp["blocks"]:
        for s, (spec, bp) in enumerate(zip(cfg.period, slots)):
            kv_spec = kv_specs[s][0] if kv_specs[s] is not None else None
            layout = _kv_layout(kv_spec) if kv_spec is not None else "whole"
            if spec.kind == "attn":
                _no_head_split_cache(bp["attn"], layout)
            x, _aux, kv = _slot(cfg, spec, bp, mesh, carry, x, pos,
                                backend=backend, kv_split=layout == "heads")
            if kv is not None and layout == "seq":
                # the rank's slots copied out: a view would keep the
                # layer's whole k / v alive until the stack
                axes = _model_axes(kv_spec[2])
                kv = tuple(mesh.chunk(t, axes, 1).clone() for t in kv)
            per_slot[s].append(kv)
    x = _norm(cfg, lp["final_norm"], x, carry)
    kvs = tuple(None if spec.kind != "attn" else
                tuple(torch.stack(leaf) for leaf in zip(*got))
                for spec, got in zip(cfg.period, per_slot))
    return _logits(cfg, lp, mesh, x[:, -1, :]), kvs


def _period_tp(cfg, mesh, carry: _Carry, backend: str, kv_split: bool,
               slots: Local, x: torch.Tensor, pos: torch.Tensor):
    """One repeat of the period on a rank, the unit remat checkpoints.
    Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, bp in zip(cfg.period, slots):
        x, a, _kv = _slot(cfg, spec, bp, mesh, carry, x, pos,
                          backend=backend, kv_split=kv_split)
        if a is not None:
            aux = aux + a
    return x, aux


def lm_forward_tp(lp: Local, cfg, mesh, inputs: torch.Tensor,
                  pos: torch.Tensor, *, backend: str = "cuda"):
    """`repro_torch.nn.transformer.lm_forward` (no kv) on a rank: returns
    (hidden (B_l, S, d), whole over ``model``, and the MoE aux loss).
    The hidden's gradient is read as the unembedding uses it: summed over
    ``model`` for a vocab-parallel one (each rank's loss part reads all
    of it, `_Carry.enter`), taken whole for a whole one (every rank's
    loss is the whole, `_Carry.share`).  Under grad mode each repeat of
    the period is checkpointed as ``cfg.remat`` says; with
    ``cfg.seq_shard_carry`` (and S divisible by the model axis, else the
    carry stays whole, as the reference's constraint falls back) the
    carry is split over the sequence."""
    from repro_torch.nn.transformer import _maybe_remat
    tp = mesh.size(MODEL)
    seq = cfg.seq_shard_carry and tp > 1 and inputs.shape[1] % tp == 0
    carry = _Carry(mesh, seq)
    kv_split = cfg.n_kv > 0 and cfg.n_kv % tp == 0
    x = _embed(cfg, lp, mesh, carry, inputs, pos)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = functools.partial(_period_tp, cfg, mesh, carry, backend, kv_split)
    if torch.is_grad_enabled():
        body = _maybe_remat(cfg, body)
    for slots in lp["blocks"]:
        x, a = body(slots, x, pos)
        aux = aux + a
    x = _norm(cfg, lp["final_norm"], x, carry)
    return (carry.share(x) if _unembed_whole(cfg, lp)
            else carry.enter(x)), aux


def lm_loss_tp(lp: Local, cfg, mesh, batch: dict, *, rep: int = 1):
    """`repro_torch.nn.transformer.lm_loss` on a rank, over its rows of a
    micro-batch.  Returns (loss, metrics): ``loss`` is this rank's part
    of the micro-batch's loss (the parts sum over the batch axes to the
    whole; every rank of a ``model`` slice holds the same part), with
    the cross-entropy divided by the micro-batch's whole mask count;
    ``metrics`` (``xent``, ``accuracy``, ``tokens``, ``aux_loss``,
    ``loss``) are the micro-batch's, whole, without gradients.  ``rep``:
    how many batch ranks hold the same rows (the batch axes' size when
    the micro-batch does not split over them, else 1)."""
    inputs = batch["tokens"] if cfg.frontend == "tokens" else batch["embeds"]
    hidden, aux = lm_forward_tp(lp, cfg, mesh, inputs, batch["pos"])
    labels = batch["labels"]
    mask = batch.get("mask")
    m = (torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
         if mask is None else mask.float())
    w, whole = _unembed(cfg, lp)
    kw = dict(chunk=cfg.loss_chunk, z_loss=cfg.z_loss,
              logit_softcap=cfg.final_softcap)
    if whole:
        sum_loss, sum_correct = chunked_xent_sums(hidden, w, labels, m, **kw)
    else:
        sum_loss, sum_correct = vocab_parallel_xent_sums(
            hidden, w, labels, m, mesh=mesh, axis=MODEL, **kw)
    with torch.no_grad():
        tot = torch.stack([sum_loss.detach(), sum_correct, m.sum()])
        tot = mesh.all_reduce(tot, batch_axes_for(mesh)) / rep
        denom = torch.clamp(tot[2], min=1.0)
    loss = sum_loss / (denom * rep) + cfg.aux_loss_weight * aux
    xent = tot[0] / denom
    aux = aux.detach()
    return loss, {"xent": xent, "accuracy": tot[1] / denom, "tokens": denom,
                  "aux_loss": aux, "loss": xent + cfg.aux_loss_weight * aux}


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
    carry = _Carry(mesh)
    x = _embed(cfg, lp, mesh, carry, inp, pos_embed)
    reduce = lambda y: mesh.all_reduce(y, MODEL)  # noqa: E731
    for r, slots in enumerate(lp["blocks"]):
        for s, (spec, bp) in enumerate(zip(cfg.period, slots)):
            layer = {k: v[r] for k, v in cache.tree[s].items()}
            h = _norm(cfg, bp["norm1"], x, carry)
            if spec.kind == "attn":
                h = _attention_decode(cfg.attn_params(spec), bp["attn"], mesh,
                                      h, layer, cache.specs[s]["k"], t, pos)
            else:
                p, mp, whole = _mamba_local(cfg.mamba, bp["mamba"], mesh,
                                            carry)
                h, new = mamba_decode(p, h, layer, mp,
                                      _same if whole else reduce)
                for k, v in new.items():
                    layer[k].copy_(v)
            if cfg.post_norm:
                h = _norm(cfg, bp["post1"], h, carry)
            x, _aux = _ffn(cfg, spec, bp, mesh, carry, x + h)
    x = _norm(cfg, lp["final_norm"], x, carry)
    return _logits(cfg, lp, mesh, x[:, 0])
