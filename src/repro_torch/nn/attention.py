"""Attention: GQA + RoPE / M-RoPE + blockwise causal + sliding windows +
decode over a KV cache.

Port of `src/repro/nn/attention.py`: `rope` (:46), `m_rope` (:55),
`AttnParams` (:83), `attention_init` (:101), `_qkv` / `_head_rms` (:124,
:141), `blockwise_attention` (:198) with its three ``causal_mode``s,
`init_cache` (:326), `decode_attention` (:333), `attention_forward`
(:360) and `attention_decode` (:380).

The reference computes attention in XLA ops, outside any Pallas kernel,
so the port is plain PyTorch: the same float32 block algorithm (logits
in float32, masked with ``-1e30``, the softmax denominator floored at
``1e-30``), with Python loops over the query and key chunks in place of
`lax.map` / `lax.scan`.  ``"triangle"`` computes only the live key chunks
of each query row; the reference computes the dead ones and masks them
to exact zeros, so the results are the same.

Layout.  ``q`` (B, S, H, hd); ``k`` / ``v`` (B, S, K, hd) with H a
multiple of K (GQA); causality and windows come from absolute positions,
batch row 0's for the whole batch (``pos[0]``, as the reference).  A
windowed layer's decode cache is a ring buffer ``min(window, max_seq)``
wide.  `attention_decode` writes the step's key and value into the
cache it is given, in place, and returns that cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.nn.layers import Initializer

__all__ = ["AttnParams", "attention_init", "rope", "m_rope",
           "blockwise_attention", "decode_attention", "attention_forward",
           "attention_decode", "attention_axes", "init_cache",
           "CAUSAL_MODES"]

CAUSAL_MODES = ("flash", "masked_full", "triangle")
_NEG = -1e30


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) rotated by ang (B, S, hd/2), in float32, cast back."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, hd), pos (B, S) -> rotated x (same dtype)."""
    ang = pos[..., None].float() * _inv_freq(x.shape[-1] // 2, theta,
                                             x.device)
    return _rotate(x, ang)


def m_rope(x: torch.Tensor, pos3: torch.Tensor, sections: tuple, *,
           theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): head_dim/2 split into (t, h, w)
    sections.  x (B, S, H, hd); pos3 (B, 3, S)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not sum to head_dim/2 "
                         f"= {half}")
    # built from the Python ints: a repeat count held in a tensor gives
    # an output shape fake tensors (the dry-run) cannot know
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (half,)
    pos = pos3.float()[:, sec_id, :]                  # (B, half, S)
    ang = pos.transpose(1, 2) * _inv_freq(half, theta, x.device)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnParams:
    n_heads: int
    n_kv: int
    head_dim: int
    rope: str = "rope"            # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    window: Optional[int] = None  # sliding window (tokens), None = global
    softcap: Optional[float] = None
    qk_norm: bool = False
    bias: bool = False
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    fused_qkv: bool = True        # one (d, H+2K, hd) projection

    @property
    def scale(self) -> float:
        return (self.query_scale if self.query_scale is not None
                else 1.0 / math.sqrt(self.head_dim))


def attention_init(init: Initializer, d_model: int, ap: AttnParams) -> dict:
    """The reference's fan-in rule holds: ``wqkv`` (d, H+2K, hd) draws at
    1/sqrt(H+2K), ``wo`` (H, hd, d) at 1/sqrt(hd)."""
    H, K, hd = ap.n_heads, ap.n_kv, ap.head_dim
    p = {}
    if ap.fused_qkv:
        p["wqkv"] = init.weight((d_model, H + 2 * K, hd))
    else:
        p["wq"] = init.weight((d_model, H, hd))
        p["wk"] = init.weight((d_model, K, hd))
        p["wv"] = init.weight((d_model, K, hd))
    p["wo"] = init.weight((H, hd, d_model))
    if ap.bias:
        for n, shape in [("bq", (H, hd)), ("bk", (K, hd)), ("bv", (K, hd)),
                         ("bo", (d_model,))]:
            p[n] = init.weight(shape, zero=True)
    if ap.qk_norm:
        p["qnorm"] = init.weight((hd,), zero=True)
        p["knorm"] = init.weight((hd,), zero=True)
    return p


def attention_axes(ap: AttnParams) -> dict:
    """Logical axes of `attention_init`'s leaves (the reference declares
    them in its init)."""
    ax = {}
    if ap.fused_qkv:
        ax["wqkv"] = ("embed", "heads", "head_dim")
    else:
        ax["wq"] = ("embed", "heads", "head_dim")
        ax["wk"] = ax["wv"] = ("embed", "kv_heads", "head_dim")
    ax["wo"] = ("heads", "head_dim", "embed")
    if ap.bias:
        ax.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                  bv=("kv_heads", "head_dim"), bo=("embed",))
    if ap.qk_norm:
        ax["qnorm"] = ax["knorm"] = ("head_dim",)
    return ax


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul, in x's dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: dict, ap: AttnParams, x: torch.Tensor):
    if ap.fused_qkv:
        H, K = ap.n_heads, ap.n_kv
        qkv = _project(x, p["wqkv"])
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    else:
        q, k, v = (_project(x, p["wq"]), _project(x, p["wk"]),
                   _project(x, p["wv"]))
    if ap.bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if ap.qk_norm:
        q = _head_rms(q, p["qnorm"])
        k = _head_rms(k, p["knorm"])
    return q, k, v


def _head_rms(x: torch.Tensor, g: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + g.float())).to(x.dtype)


def _apply_rope(ap: AttnParams, q, k, pos):
    if ap.rope == "rope":
        return (rope(q, pos, theta=ap.rope_theta),
                rope(k, pos, theta=ap.rope_theta))
    if ap.rope == "mrope":
        return (m_rope(q, pos, ap.mrope_sections, theta=ap.rope_theta),
                m_rope(k, pos, ap.mrope_sections, theta=ap.rope_theta))
    return q, k


# ---------------------------------------------------------------------------
# blockwise causal attention (prefill)
# ---------------------------------------------------------------------------

def _mask(qpos, kpos, window):
    """(qc, kc) bool: key position <= query position (and inside the
    window)."""
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return mask


def _block_attn(q, k, v, qpos, kpos, *, scale, softcap, window):
    """One (qc, kc) tile: returns (out_unnorm (B,qc,H,hd), row_max
    (B,H,qc), row_denom (B,H,qc)); q (B,qc,H,hd), k/v (B,kc,H,hd)."""
    logits = torch.einsum("bqhd,bchd->bhqc", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _mask(qpos, kpos, window)
    logits = torch.where(mask, logits, _NEG)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    out = torch.einsum("bhqc,bchd->bqhd", p, v.float())
    return out, m, p.sum(dim=-1)


def _merge(acc, new):
    """Online-softmax merge of two partial attention results."""
    out0, m0, d0 = acc
    out1, m1, d1 = new
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
    out = (out0 * a0.transpose(1, 2)[..., None]
           + out1 * a1.transpose(1, 2)[..., None])
    return out, m, d0 * a0 + d1 * a1


def _normalize(out, d):
    return out / torch.clamp(d, min=1e-30).transpose(1, 2)[..., None]


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def chunks_of(S: int, q_chunk: int, kv_chunk: int) -> tuple:
    """``(qc, kc)``: the chunks clipped to S; raises unless both divide
    S (the reference asserts it)."""
    qc, kc = min(q_chunk, S), min(kv_chunk, S)
    if S % qc or S % kc:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"query / key chunks ({qc}, {kc})")
    return qc, kc


def band_of(window: int, qc: int, kc: int, S: int) -> int:
    """Keys a windowed query chunk can see: whole key chunks covering
    window + qc, plus one, clipped to S."""
    return min((-(-(window + qc) // kc) + 1) * kc, S)


def blockwise_attention(q, k, v, *, q_pos, kv_pos, window=None, softcap=None,
                        scale=None, q_chunk: int = 512, kv_chunk: int = 512,
                        causal_mode: str = "flash") -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,K,hd) -> (B,S,H,hd) float32.

    q_pos / kv_pos: (S,) absolute positions (causality = kv_pos <= q_pos).
    ``causal_mode``: ``"flash"`` (`repro_torch.nn.flash`, O(S) memory),
    ``"masked_full"`` (the whole block grid with masking; windowed layers
    take a static band of keys per query chunk) or ``"triangle"`` (only
    the causal half of the block grid)."""
    if causal_mode not in CAUSAL_MODES:
        raise ValueError(f"causal_mode must be one of {CAUSAL_MODES}, got "
                         f"{causal_mode!r}")
    B, S, H, hd = q.shape
    n_rep = H // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if causal_mode == "flash":
        from repro_torch.nn.flash import flash_attention
        return flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               scale=scale, softcap=softcap, window=window,
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
    qc, kc = chunks_of(S, q_chunk, kv_chunk)
    nq, nk = S // qc, S // kc
    kw = dict(scale=scale, softcap=softcap)
    rows = []
    if window is not None:
        band = band_of(window, qc, kc, S)
        for qi in range(nq):
            start = min(max(qi * qc + qc - band, 0), S - band)
            out, _, d = _block_attn(
                q[:, qi * qc:(qi + 1) * qc], k[:, start:start + band],
                v[:, start:start + band], q_pos[qi * qc:(qi + 1) * qc],
                kv_pos[start:start + band], window=window, **kw)
            rows.append(_normalize(out, d))
        return torch.cat(rows, dim=1)
    # "triangle" pairs row i with row nq-1-i in the reference so that a
    # static scan sees the causal half; here each row takes its live chunks
    live = (lambda qi: qi + 1) if (causal_mode == "triangle" and nq == nk
                                   and nq >= 2) else (lambda qi: nk)
    for qi in range(nq):
        qb, qp = q[:, qi * qc:(qi + 1) * qc], q_pos[qi * qc:(qi + 1) * qc]
        acc = (torch.zeros((B, qc, H, hd), dtype=torch.float32,
                           device=q.device),
               torch.full((B, H, qc), _NEG, dtype=torch.float32,
                          device=q.device),
               torch.zeros((B, H, qc), dtype=torch.float32, device=q.device))
        for ki in range(live(qi)):
            sl = slice(ki * kc, (ki + 1) * kc)
            acc = _merge(acc, _block_attn(qb, k[:, sl], v[:, sl], qp,
                                          kv_pos[sl], window=None, **kw))
        rows.append(_normalize(acc[0], acc[2]))
    return torch.cat(rows, dim=1)


# ---------------------------------------------------------------------------
# decode attention over a KV cache
# ---------------------------------------------------------------------------

def init_cache(batch: int, ap: AttnParams, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, *, device) -> dict:
    """One attention layer's cache; a windowed layer's is a ring buffer
    ``min(window, max_seq)`` wide."""
    S = min(ap.window, max_seq) if ap.window is not None else max_seq
    shape = (batch, S, ap.n_kv, ap.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(q, cache_k, cache_v, kv_pos, q_pos, *, scale,
                     softcap=None, window=None) -> torch.Tensor:
    """q (B, 1, H, hd); cache_k/v (B, Sc, K, hd); kv_pos (Sc,) absolute
    positions of the cache entries (-1 = empty slot); q_pos the query's
    position.  Returns (B, 1, H, hd) float32."""
    B, _, H, hd = q.shape
    K = cache_k.shape[2]
    qg = q.float().reshape(B, K, H // K, hd)     # query heads by kv head
    logits = torch.einsum("bkrd,bskd->bkrs", qg, cache_k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos)
    if window is not None:
        valid &= kv_pos > (q_pos - window)
    logits = torch.where(valid, logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, cache_v.float())
    return out.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# full attention layer forward (prefill) and decode step
# ---------------------------------------------------------------------------

def _out_proj(p: dict, ap: AttnParams, out: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """einsum("bshd,hdm->bsm") in the activation dtype, plus the bias."""
    H, hd, d = p["wo"].shape
    y = out.to(dtype).flatten(-2) @ p["wo"].to(dtype).reshape(H * hd, d)
    if ap.bias:
        y = y + p["bo"].to(dtype)
    return y


def attention_forward(p: dict, ap: AttnParams, x: torch.Tensor, pos, *,
                      q_chunk=512, kv_chunk=512, causal_mode="masked_full",
                      return_kv: bool = False):
    """x (B,S,d); pos (B,S) int (or (B,3,S) for mrope).  With
    ``return_kv`` also the rotated keys and the values, (B,S,K,hd) each
    in x's dtype."""
    q, k, v = _qkv(p, ap, x)
    q, k = _apply_rope(ap, q, k, pos)
    pos1d = pos[0] if ap.rope != "mrope" else pos[0, 0]
    out = blockwise_attention(q, k, v, q_pos=pos1d, kv_pos=pos1d,
                              window=ap.window, softcap=ap.softcap,
                              scale=ap.scale, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, causal_mode=causal_mode)
    y = _out_proj(p, ap, out, x.dtype)
    return (y, (k, v)) if return_kv else y


def ring_positions(t: int, Sc: int, *, windowed: bool, device) -> torch.Tensor:
    """Absolute position held by each of the Sc cache slots once step
    ``t`` is written (-1 = empty): the ring buffer's write head is
    ``t % Sc``; a global cache holds position s at slot s."""
    idx = torch.arange(Sc, device=device)
    if not windowed:
        return torch.where(idx <= t, idx, -1)
    kv_pos = t - ((t % Sc) - idx) % Sc
    kv_pos = torch.where(kv_pos > t, kv_pos - Sc, kv_pos)
    return torch.where(kv_pos < 0, -1, kv_pos)


def attention_decode(p: dict, ap: AttnParams, x: torch.Tensor, cache: dict,
                     t: int, pos):
    """One decode step.  x (B,1,d); t the current position (an int); pos
    (B,1) (or (B,3,1) for mrope).  Writes the step's k / v into ``cache``
    in place; returns (y, cache)."""
    t = int(t)
    q, k, v = _qkv(p, ap, x)
    q, k = _apply_rope(ap, q, k, pos)
    Sc = cache["k"].shape[1]
    slot = t % Sc if ap.window is not None else t
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    kv_pos = ring_positions(t, Sc, windowed=ap.window is not None,
                            device=x.device)
    out = decode_attention(q, cache["k"], cache["v"], kv_pos, t,
                           scale=ap.scale, softcap=ap.softcap,
                           window=ap.window)
    return _out_proj(p, ap, out, x.dtype), cache
