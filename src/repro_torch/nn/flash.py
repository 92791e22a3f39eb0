"""Flash attention: O(S) live memory in the forward AND the backward.

Port of `src/repro/nn/flash.py`: `FlashCfg` (:35), `_scores` (:43),
`_fwd_row` (:55), `_fwd_impl` (:82) with its banded branch (:90), the
custom VJP `_flash` / `_flash_fwd` / `_flash_bwd` (:120-197), here the
`torch.autograd.Function` `_Flash`, and `flash_attention` (:200).

Same float32 algorithm as the reference (a `lax.scan` there, Python
loops here): per query chunk, a running max, denominator and output over
the key chunks, masked logits at ``-1e30``, the denominator floored at
``1e-30``.  A windowed layer whose window plus a query chunk is shorter
than the sequence takes only the band of key chunks it can see.

The backward is FlashAttention-2's recipe as the reference writes it:
the residuals are ``q, k, v, q_pos, kv_pos, out, lse``; per (key chunk,
query chunk) block it recomputes the capped scores and ``p`` from
``lse`` and accumulates ``dv``, ``ds = p (dp - delta)`` (times
``1 - tanh^2`` under a softcap), ``dq`` and ``dk`` in float32, walking
every key chunk under the mask (windowed layers too), and returns the
cotangents in the inputs' dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.nn.attention import _NEG, _mask, band_of, chunks_of

__all__ = ["FlashCfg", "flash_attention"]


@dataclasses.dataclass(frozen=True)
class FlashCfg:
    scale: float
    softcap: Optional[float]
    window: Optional[int]
    qc: int
    kc: int


def _scores(cfg: FlashCfg, qb, kb, qp, kp):
    """(B,qc,H,hd) x (B,kc,H,hd) -> (capped logits (B,H,qc,kc), mask)."""
    raw = torch.einsum("bqhd,bchd->bhqc", qb.float(), kb.float()) * cfg.scale
    if cfg.softcap is not None:
        raw = cfg.softcap * torch.tanh(raw / cfg.softcap)
    return raw, _mask(qp, kp, cfg.window)


def _fwd_row(cfg: FlashCfg, qb, qp, k, v, kp):
    """One query chunk against the keys ``k`` / ``v`` (B, n*kc, H, hd),
    positions ``kp`` (n*kc,), chunk by chunk.  Returns (out (B,qc,H,hd)
    float32 normalized, lse (B,H,qc))."""
    B, qc, H, hd = qb.shape
    out = torch.zeros((B, qc, H, hd), dtype=torch.float32, device=qb.device)
    m = torch.full((B, H, qc), _NEG, dtype=torch.float32, device=qb.device)
    d = torch.zeros((B, H, qc), dtype=torch.float32, device=qb.device)
    for c0 in range(0, k.shape[1], cfg.kc):
        sl = slice(c0, c0 + cfg.kc)
        logits, mask = _scores(cfg, qb, k[:, sl], qp, kp[sl])
        logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        out = (out * alpha.transpose(1, 2)[..., None]
               + torch.einsum("bhqc,bchd->bqhd", p, v[:, sl].float()))
        d = d * alpha + p.sum(dim=-1)
        m = m_new
    d_safe = torch.clamp(d, min=1e-30)
    return out / d_safe.transpose(1, 2)[..., None], m + torch.log(d_safe)


def _fwd_impl(cfg: FlashCfg, q, k, v, q_pos, kv_pos):
    """Returns (out (B,S,H,hd) float32, lse (B,H,S))."""
    B, S, H, hd = q.shape
    qc, kc = chunks_of(S, cfg.qc, cfg.kc)
    cfg = dataclasses.replace(cfg, qc=qc, kc=kc)
    banded = cfg.window is not None and cfg.window + qc < S
    band = band_of(cfg.window, qc, kc, S) if banded else S
    outs, lses = [], []
    for qi in range(S // qc):
        # the band of key chunks this row can see (all of them unbanded)
        start = min(max(qi * qc + qc - band, 0), S - band)
        ks = slice(start, start + band)
        out, lse = _fwd_row(cfg, q[:, qi * qc:(qi + 1) * qc],
                            q_pos[qi * qc:(qi + 1) * qc], k[:, ks], v[:, ks],
                            kv_pos[ks])
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _flash_bwd(cfg: FlashCfg, q, k, v, q_pos, kv_pos, out, lse, g):
    """Cotangents (dq, dk, dv) float32 of ``out`` by ``g`` (B,S,H,hd)."""
    B, S, H, hd = q.shape
    qc, kc = chunks_of(S, cfg.qc, cfg.kc)
    g = g.float()
    delta = torch.einsum("bshd,bshd->bhs", g, out)              # (B,H,S)
    dq = torch.zeros((B, S, H, hd), dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for k0 in range(0, S, kc):
        ks = slice(k0, k0 + kc)
        kb, vb, kp = k[:, ks].float(), v[:, ks].float(), kv_pos[ks]
        for q0 in range(0, S, qc):
            qs = slice(q0, q0 + qc)
            qb, gb = q[:, qs].float(), g[:, qs]
            raw = torch.einsum("bqhd,bchd->bhqc", qb, kb) * cfg.scale
            if cfg.softcap is not None:
                t = torch.tanh(raw / cfg.softcap)
                capped, dcap = cfg.softcap * t, 1.0 - t * t
            else:
                capped, dcap = raw, None
            p = torch.where(_mask(q_pos[qs], kp, cfg.window),
                            torch.exp(capped - lse[:, :, qs, None]), 0.0)
            dv[:, ks] += torch.einsum("bhqc,bqhd->bchd", p, gb)
            dp = torch.einsum("bqhd,bchd->bhqc", gb, vb)
            ds = p * (dp - delta[:, :, qs, None])
            if dcap is not None:
                ds = ds * dcap
            dq[:, qs] += torch.einsum("bhqc,bchd->bqhd", ds, kb) * cfg.scale
            dk[:, ks] += torch.einsum("bhqc,bqhd->bchd", ds, qb) * cfg.scale
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """(q, k, v) -> out float32; positions take no gradient."""

    @staticmethod
    def forward(ctx, cfg, q, k, v, q_pos, kv_pos):
        out, lse = _fwd_impl(cfg, q, k, v, q_pos, kv_pos)
        ctx.cfg = cfg
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(ctx.cfg, q, k, v, q_pos, kv_pos, out, lse, g)
        return (None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None)


def flash_attention(q, k, v, *, q_pos, kv_pos, scale=None, softcap=None,
                    window=None, q_chunk: int = 512, kv_chunk: int = 512):
    """q (B,S,H,hd), k/v (B,S,H,hd) pre-repeated -> (B,S,H,hd) float32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    cfg = FlashCfg(scale=float(scale),
                   softcap=float(softcap) if softcap is not None else None,
                   window=int(window) if window is not None else None,
                   qc=q_chunk, kc=kv_chunk)
    return _Flash.apply(cfg, q, k, v, q_pos, kv_pos)
