"""Losses.  The important one is the *chunked* softmax cross-entropy.

Port of `src/repro/nn/losses.py`: `softmax_xent_dense` (:33), the chunk
bodies `_chunk_fwd` / `_chunk_bwd` (:57, :73), the custom VJP
`_chunked_sums` / `_chunked_sums_fwd` / `_chunked_sums_bwd` (:95-139), here
the `torch.autograd.Function` `_ChunkedSums`, and `chunked_softmax_xent`
(:142).

With 32k-256k vocabularies a (B, S, V) logits tensor does not fit beside
a model: `chunked_softmax_xent` walks the SEQUENCE in chunks, computes a
(B, c, V) logits chunk, reduces it to scalar sums and drops it.  The
backward does the same: it saves only ``x``, ``w``, ``labels`` and
``mask``, recomputes each chunk's softmax and accumulates ``dW`` in
float32, so in both passes one (B, c, V) chunk is the only live logits.

Port-only: `chunked_xent_sums`, the sums `chunked_softmax_xent` divides
(a rank whose unembedding is whole over the model axis computes them
whole), and `vocab_parallel_xent_sums`, the rank counterpart of
`_ChunkedSums` on a mesh (`repro_torch.nn.tensor_parallel`), over the
rank's vocab slice of the unembedding, with no logits gathered.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["chunked_softmax_xent", "chunked_xent_sums", "softmax_xent_dense",
           "vocab_parallel_xent_sums"]


def _metrics(loss, correct, denom) -> dict:
    return {"xent": loss, "accuracy": correct / denom, "tokens": denom}


def softmax_xent_dense(x: torch.Tensor, w_unembed: torch.Tensor,
                       labels: torch.Tensor, *,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 0.0,
                       logit_softcap: Optional[float] = None):
    """Reference (dense) path: x (B,S,d) @ w (d,V) vs labels (B,S).

    Returns (mean_loss, metrics).  mask: (B,S) 1.0 = count the token."""
    logits = x.float() @ w_unembed.float()
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    per_tok = lse - ll
    if z_loss:
        per_tok = per_tok + z_loss * lse ** 2
    mask = torch.ones_like(per_tok) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per_tok * mask).sum() / denom
    correct = ((logits.argmax(-1) == labels).float() * mask).sum()
    return loss, _metrics(loss, correct, denom)


def _capped(xc, w, softcap):
    """Chunk logits (B, c, V) in float32 and, under a softcap, the
    derivative of the capped logits by the raw ones (``1 - tanh^2``),
    with at most two chunk-sized tensors live."""
    raw = xc @ w
    if softcap is None:
        return raw, None
    t = raw.div_(softcap).tanh_()
    return t * softcap, t.square_().neg_().add_(1.0)


def _chunk_fwd(xc, w, yc, mc, *, z_loss, softcap):
    """One chunk: xc (B, c, d) f32, w (d, V), yc / mc (B, c) ->
    (sum_loss, sum_correct)."""
    logits, _ = _capped(xc, w, softcap)
    lse = torch.logsumexp(logits, dim=-1)                   # (B, c)
    per_tok = lse - torch.gather(logits, -1, yc[..., None])[..., 0]
    if z_loss:
        per_tok = per_tok + z_loss * lse ** 2
    correct = (logits.argmax(-1) == yc).float()
    return (per_tok * mc).sum(), (correct * mc).sum()


def _chunk_bwd(xc, w, yc, mc, g, dw, *, z_loss, softcap):
    """Backward of one chunk w.r.t. (xc, w), d(sum_loss)/d. times g:
    returns dx and adds dW into ``dw``.  Works in place on the chunk's
    logits, so the softmax, its gradient and the softcap's derivative
    share two chunk-sized buffers."""
    logits, dcap = _capped(xc, w, softcap)
    lse = torch.logsumexp(logits, dim=-1)
    p = logits.sub_(lse[..., None]).exp_()
    # d per_tok / d logits = p (1 + 2 z lse) minus the label's one-hot
    if z_loss:
        p.mul_(1.0 + (2.0 * z_loss) * lse[..., None])
    dlogits = p.scatter_add_(-1, yc[..., None],
                             torch.full_like(p[..., :1], -1.0))
    dlogits.mul_((mc * g)[..., None])
    if dcap is not None:
        dlogits.mul_(dcap)
    dw.addmm_(xc.flatten(0, 1).T, dlogits.flatten(0, 1))
    return dlogits @ w.T


def _chunks(S: int, c: int):
    return [slice(i, i + c) for i in range(0, S, c)]


class _ChunkedSums(torch.autograd.Function):
    """x (B,S,d) f32, w (d,V) f32, labels (B,S), mask (B,S) f32 ->
    (sum_loss, sum_correct), walking S in chunks of ``c``.  ``accuracy``
    (sum_correct) takes no gradient."""

    @staticmethod
    def forward(ctx, x, w, labels, mask, c, z_loss, softcap):
        sl = torch.zeros((), dtype=torch.float32, device=x.device)
        sc = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in _chunks(x.shape[1], c):
            a, b = _chunk_fwd(x[:, s], w, labels[:, s], mask[:, s],
                              z_loss=z_loss, softcap=softcap)
            sl, sc = sl + a, sc + b
        ctx.save_for_backward(x, w, labels, mask)
        ctx.cfg = (c, z_loss, softcap)
        ctx.mark_non_differentiable(sc)
        return sl, sc

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        x, w, labels, mask = ctx.saved_tensors
        c, z_loss, softcap = ctx.cfg
        dx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w, dtype=torch.float32)
        for s in _chunks(x.shape[1], c):
            dxc = _chunk_bwd(x[:, s], w, labels[:, s], mask[:, s], g_loss,
                             dw, z_loss=z_loss, softcap=softcap)
            if dx is not None:
                dx[:, s] = dxc
        return (dx, dw if ctx.needs_input_grad[1] else None,
                None, None, None, None, None)


def chunked_softmax_xent(x: torch.Tensor, w_unembed: torch.Tensor,
                         labels: torch.Tensor, *,
                         mask: Optional[torch.Tensor] = None,
                         chunk: int = 512, z_loss: float = 0.0,
                         logit_softcap: Optional[float] = None):
    """Chunked CE: x (B,S,d), w (d,V), labels (B,S) -> (mean_loss, metrics).

    The sequence is walked ``chunk`` tokens at a time (the largest chunk
    up to ``chunk`` that divides S); a chunk's logits never outlive its
    step, forward AND backward.  metrics: ``xent``, ``accuracy``,
    ``tokens``."""
    B, S, _ = x.shape
    m = (torch.ones((B, S), dtype=torch.float32, device=x.device)
         if mask is None else mask.float())
    sum_loss, sum_correct = chunked_xent_sums(
        x, w_unembed, labels, m, chunk=chunk, z_loss=z_loss,
        logit_softcap=logit_softcap)
    denom = torch.clamp(m.sum(), min=1.0)
    loss = sum_loss / denom
    return loss, _metrics(loss, sum_correct, denom)


def _chunk_of(S: int, chunk: int) -> int:
    """The largest chunk up to ``chunk`` that divides S."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def chunked_xent_sums(x: torch.Tensor, w: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor, *,
                      chunk: int = 512, z_loss: float = 0.0,
                      logit_softcap: Optional[float] = None):
    """`chunked_softmax_xent`'s sums: x (B,S,d), w (d,V), labels / mask
    (B,S) -> (sum_loss, sum_correct) over the mask (``sum_correct``
    takes no gradient).  Inside a rank whose unembedding is whole over
    the model axis it is the loss every model rank computes whole."""
    return _ChunkedSums.apply(
        x.float(), w.float(), labels.long(), mask.float(),
        _chunk_of(x.shape[1], chunk), float(z_loss),
        None if logit_softcap is None else float(logit_softcap))


class _VocabParallelSums(torch.autograd.Function):
    """Inside a rank: x (B,S,d) f32, whole over ``axis``; w (d, V/tp) f32,
    the rank's vocab slice ``[v0, v0 + V/tp)``; labels / mask (B,S) ->
    (sum_loss, sum_correct) over the rank's rows, the same on every rank
    of ``axis``.  Per chunk: a max all-reduce of the slices' maxima, then
    one sum all-reduce of the slices' exp sums at that maximum, the
    label's logit (from the rank that owns it), whether it is the
    maximum, and how many logits before it reach the maximum (so
    ``accuracy`` is the whole vocab's first-index argmax).  Saves ``x``,
    ``w``, the labels, the mask and the (B,S) log-sum-exp; the backward
    recomputes each chunk's logits slice and needs no collective.  Its
    ``dx`` is the rank's part (the caller's copy into the layer sums it
    over ``axis``); ``dw`` the rank's slice, whole."""

    @staticmethod
    def forward(ctx, x, w, labels, mask, c, z_loss, softcap, mesh, axis):
        Vl = w.shape[1]
        v0 = mesh.index(axis) * Vl
        cols = torch.arange(v0, v0 + Vl, device=x.device)
        sl = torch.zeros((), dtype=torch.float32, device=x.device)
        sc = torch.zeros((), dtype=torch.float32, device=x.device)
        lse = torch.empty(labels.shape, dtype=torch.float32, device=x.device)
        for s in _chunks(x.shape[1], c):
            logits, _ = _capped(x[:, s], w, softcap)            # (B, c, Vl)
            yc = labels[:, s]
            m = mesh.all_reduce(logits.amax(dim=-1), axis, op="max")
            yl = yc - v0
            own = (yl >= 0) & (yl < Vl)
            ll = torch.gather(logits, -1, yl.clamp(0, Vl - 1)[..., None]
                              )[..., 0]
            top = logits == m[..., None]
            packed = torch.stack([
                torch.exp(logits - m[..., None]).sum(dim=-1),
                torch.where(own, ll, 0.0),
                (own & (ll == m)).float(),
                (top & (cols < yc[..., None])).sum(dim=-1).float()], dim=-1)
            packed = mesh.all_reduce(packed, axis)
            lc = m + torch.log(packed[..., 0])
            per_tok = lc - packed[..., 1]
            if z_loss:
                per_tok = per_tok + z_loss * lc ** 2
            correct = ((packed[..., 2] > 0) & (packed[..., 3] == 0)).float()
            mc = mask[:, s]
            sl, sc = sl + (per_tok * mc).sum(), sc + (correct * mc).sum()
            lse[:, s] = lc
        ctx.save_for_backward(x, w, labels, mask, lse)
        ctx.cfg = (c, z_loss, softcap, v0)
        ctx.mark_non_differentiable(sc)
        return sl, sc

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        x, w, labels, mask, lse = ctx.saved_tensors
        c, z_loss, softcap, v0 = ctx.cfg
        Vl = w.shape[1]
        dx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w, dtype=torch.float32)
        for s in _chunks(x.shape[1], c):
            xc, lc = x[:, s], lse[:, s]
            logits, dcap = _capped(xc, w, softcap)
            p = logits.sub_(lc[..., None]).exp_()
            if z_loss:
                p.mul_(1.0 + (2.0 * z_loss) * lc[..., None])
            yl = labels[:, s] - v0
            own = (yl >= 0) & (yl < Vl)
            dlogits = p.scatter_add_(-1, yl.clamp(0, Vl - 1)[..., None],
                                     -own[..., None].to(p.dtype))
            dlogits.mul_((mask[:, s] * g_loss)[..., None])
            if dcap is not None:
                dlogits.mul_(dcap)
            dw.addmm_(xc.flatten(0, 1).T, dlogits.flatten(0, 1))
            if dx is not None:
                dx[:, s] = dlogits @ w.T
        return (dx, dw if ctx.needs_input_grad[1] else None,
                None, None, None, None, None, None, None)


def vocab_parallel_xent_sums(x: torch.Tensor, w: torch.Tensor,
                             labels: torch.Tensor, mask: torch.Tensor, *,
                             mesh, axis: str, chunk: int = 512,
                             z_loss: float = 0.0,
                             logit_softcap: Optional[float] = None):
    """Inside a rank: `chunked_softmax_xent`'s sums over the vocab split
    on ``axis`` of ``mesh`` (an `AxisGroups`).  x (B,S,d) whole over
    ``axis``, w (d, V/tp) the rank's slice, labels / mask (B,S) ->
    (sum_loss, sum_correct), the same on every rank of ``axis``
    (``sum_correct`` takes no gradient).  Chunks as
    `chunked_softmax_xent`'s."""
    return _VocabParallelSums.apply(
        x.float(), w.float(), labels.long(), mask.float(),
        _chunk_of(x.shape[1], chunk), float(z_loss),
        None if logit_softcap is None else float(logit_softcap), mesh, axis)
