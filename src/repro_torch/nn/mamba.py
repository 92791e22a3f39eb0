"""Mamba-1 selective SSM block (the falcon-mamba and jamba Mamba layers).

Port of `src/repro/nn/mamba.py`: `MambaParams` (:29), `mamba_init` (:42),
`_causal_conv` (:70), `_ssm_inputs` (:81), `_chunk_scan` (:94),
`mamba_forward` (:105), `_mamba_forward_pallas` (:162, here
`_mamba_forward_fused`), `init_mamba_state` (:188) and `mamba_decode`
(:196).

Prefill runs one of two paths, as in the reference:

  * the fused scan (``fused_scan="on"``): projections, conv and gating in
    PyTorch, the discretize + scan core in the CUDA kernel
    (``backend="cuda"``, CUDA tensors only) or its plain version
    (``backend="torch"``, any device).  Inference only: there is no
    backward, as the reference's Pallas path has none, so under autograd
    (grad mode on, and ``x`` or a parameter requiring a gradient) it
    raises `NotImplementedError` on either backend; training rewrites
    the config to the chunked path (`models.lm.make_train_step`).
  * the chunked path (``fused_scan="off"``): a loop over ``chunk``-token
    slices carrying the SSM state and the conv tail, with an associative
    scan inside each chunk (the reference's `lax.scan` over chunks).  It
    also serves ``h0`` / ``return_state``, which the fused path does not
    take.

Decode is the O(1) recurrent update: state (B, d_inner, d_state) plus a
(d_conv-1)-deep causal-conv tail; it runs no kernel.

On a mesh (`repro_torch.nn.tensor_parallel`) a rank holds a slice of
``d_inner``: ``in_proj``, the conv, ``dt_proj`` and the scan are local
per channel, and ``x_proj`` and ``out_proj`` contract ``d_inner``, so
their products are partial sums: ``reduce`` (an all-reduce over the
model axis) completes them.  Under autograd the two sums differ in their
backward: every rank reads the whole ``x_proj`` product in its own
channels, so ``reduce_ssm`` (default ``reduce``) also sums its gradient,
while ``reduce`` ends the block.  Without them the block is the
one-device block.

Rounding points follow the reference: the in/out projections run in the
activation dtype (bf16 on `falcon_mamba_7b.full()`), the conv, the SSM
inputs and the scan in float32, and the decode cache keeps its conv tail
in the cache dtype.  The conv is d_conv shifted multiply-adds in float32,
not `torch.nn.functional.conv1d` (cuDNN runs float32 convolutions in TF32
by default).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import softplus
from repro_torch.kernels.selective_scan import (refuse_grad, selective_scan,
                                                selective_scan_plain)
from repro_torch.nn.layers import Initializer

__all__ = ["BACKENDS", "MambaParams", "mamba_init", "mamba_axes",
           "mamba_forward", "mamba_decode", "init_mamba_state"]

BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class MambaParams:
    """Mamba-1 block widths.

    ``fused_scan`` takes the place of the reference's ``pallas_scan``.
    The reference defaults to ``"off"`` (its `full()` configs keep the
    XLA chunked path; only ``"auto"`` on a TPU or ``"interpret"`` runs its
    Pallas kernel); the port defaults to ``"on"``, so every port config,
    `falcon_mamba_7b.full()` included, prefills through the scan kernel.
    ``"off"`` keeps the chunked plain path, the one training takes."""

    d_inner: int
    d_state: int = 16
    dt_rank: int = 0          # 0 => d_model // 16
    d_conv: int = 4
    chunk: int = 256
    fused_scan: str = "on"    # "on" | "off"

    def __post_init__(self):
        if self.fused_scan not in ("on", "off"):
            raise ValueError(f"fused_scan must be 'on' or 'off', got "
                             f"{self.fused_scan!r}")


def mamba_init(init: Initializer, d_model: int, mp: MambaParams) -> dict:
    dt_rank = mp.dt_rank or max(1, d_model // 16)
    p = {
        "in_proj": init.weight((d_model, 2, mp.d_inner)),
        "conv_w": init.weight((mp.d_conv, mp.d_inner), scale=0.5),
        "conv_b": init.weight((mp.d_inner,), zero=True),
        "x_proj": init.weight((mp.d_inner, dt_rank + 2 * mp.d_state)),
        "dt_proj": init.weight((dt_rank, mp.d_inner)),
        "dt_bias": init.weight((mp.d_inner,), zero=True),
        # S4D-real init: log(1..N) broadcast over d_inner
        "A_log": torch.log(torch.arange(
            1, mp.d_state + 1, dtype=torch.float32, device=init.device)
        ).expand(mp.d_inner, -1).to(init.dtype).contiguous(),
    }
    p["D"] = init.weight((mp.d_inner,), zero=True)
    p["out_proj"] = init.weight((mp.d_inner, d_model))
    return p


def mamba_axes(mp: MambaParams) -> dict:
    """Logical axes of `mamba_init`'s leaves: ``d_inner`` is "inner"."""
    return {"in_proj": ("embed", None, "inner"), "conv_w": ("conv", "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", None),
            "dt_proj": (None, "inner"), "dt_bias": ("inner",),
            "A_log": ("inner", "state"), "D": ("inner",),
            "out_proj": ("inner", "embed")}


def _in_proj(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d_model) -> xz (B, S, 2, d_inner) in x's dtype."""
    w = p["in_proj"].to(x.dtype)
    d_model, _, di = w.shape
    return (x @ w.reshape(d_model, 2 * di)).reshape(*x.shape[:-1], 2, di)


def _out_proj(p: dict, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return y.to(dtype) @ p["out_proj"].to(dtype)


def _causal_conv(p: dict, x: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Depthwise causal conv, width d_conv. x (B, S, d_inner) -> float32."""
    w = p["conv_w"].float()
    xf = x.float()
    seq = x.shape[1]
    acc = torch.zeros_like(xf)
    for i in range(d_conv):
        shift = d_conv - 1 - i
        xi = F.pad(xf, (0, 0, shift, 0))[:, :seq]
        acc = acc + xi * w[i]
    return acc + p["conv_b"].float()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _ssm_inputs(p: dict, xc: torch.Tensor, mp: MambaParams,
                reduce: Callable = _same):
    """xc (B, S', d_inner) f32 -> (a, b, C) for h_t = a_t h_{t-1} + b_t."""
    dt_rank = p["dt_proj"].shape[0]
    xdbc = reduce(xc @ p["x_proj"].float())
    dt_low, b_ssm, c_ssm = torch.split(
        xdbc, [dt_rank, mp.d_state, mp.d_state], dim=-1)
    dt = softplus(dt_low @ p["dt_proj"].float() + p["dt_bias"].float())
    a_mat = -torch.exp(p["A_log"].float())                        # (di, N)
    a = torch.exp(dt[..., None] * a_mat)                          # (B,S',di,N)
    b = (dt * xc)[..., None] * b_ssm[:, :, None, :]               # (B,S',di,N)
    return a, b, c_ssm


def _chunk_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Within-chunk associative scan. a, b (B, c, di, N); h0 (B, di, N).

    Recursive doubling over the chunk with the reference's combine
    ``(al, bl), (ar, br) -> (al ar, bl ar + br)``."""
    c = a.shape[1]
    off = 1
    while off < c:
        a, b = (torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1),
                torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                          dim=1))
        off *= 2
    h = a * h0[:, None] + b                                       # (B,c,di,N)
    return h, h[:, -1]


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def mamba_forward(p: dict, x: torch.Tensor, mp: MambaParams,
                  h0: Optional[torch.Tensor] = None,
                  return_state: bool = False, *, backend: str = "cuda",
                  reduce: Callable = _same,
                  reduce_ssm: Optional[Callable] = None):
    """x (B, S, d_model) -> (B, S, d_model).

    The fused path (``mp.fused_scan == "on"``, no ``h0``, no
    ``return_state``) takes any S.  The chunked path needs S divisible by
    ``min(chunk, S)``; its live memory is O(B * chunk * d_inner * N).
    ``reduce`` completes the ``out_proj`` product of a ``d_inner`` slice
    and ``reduce_ssm`` (default ``reduce``) the ``x_proj`` one (see the
    module docstring)."""
    _check_backend(backend)
    reduce_ssm = reduce if reduce_ssm is None else reduce_ssm
    if mp.fused_scan == "on" and h0 is None and not return_state:
        refuse_grad(x, *p.values())
        from torch._subclasses.fake_tensor import is_fake
        if backend == "cuda" and not x.is_cuda and not is_fake(x):
            raise ValueError("backend='cuda' runs the scan kernel and needs "
                             "CUDA tensors (or the dry-run's fake ones); use "
                             "backend='torch' on the CPU")
        return _mamba_forward_fused(p, x, mp, backend=backend, reduce=reduce,
                                    reduce_ssm=reduce_ssm)
    bsz, seq, _ = x.shape
    c = min(mp.chunk, seq)
    if seq % c:
        raise ValueError(f"sequence length {seq} is not a multiple of the "
                         f"chunk {c}")
    di = mp.d_inner
    dev = x.device
    h = (h0 if h0 is not None
         else torch.zeros((bsz, di, mp.d_state), dtype=torch.float32,
                          device=dev))
    tail = torch.zeros((bsz, mp.d_conv - 1, di), dtype=torch.float32,
                       device=dev)
    w = p["conv_w"].float()
    outs = []
    for k in range(seq // c):
        xk = x[:, k * c:(k + 1) * c]
        xz = _in_proj(p, xk)
        x_in, z = xz[:, :, 0], xz[:, :, 1]                       # (B, c, di)
        # depthwise causal conv over [tail ++ x_in]
        hist = torch.cat([tail, x_in.float()], dim=1)
        acc = torch.zeros((bsz, c, di), dtype=torch.float32, device=dev)
        for i in range(mp.d_conv):
            acc = acc + hist[:, i:i + c] * w[i]
        xcv = F.silu(acc + p["conv_b"].float())
        a, b, c_ssm = _ssm_inputs(p, xcv, mp, reduce_ssm)         # (B,c,di,N)
        hs, h = _chunk_scan(a, b, h)
        y = (torch.einsum("bsdn,bsn->bsd", hs, c_ssm)
             + p["D"].float() * xcv)
        y = y * F.silu(z.float())
        outs.append(_out_proj(p, y, x.dtype))
        tail = hist[:, c:]
    out = reduce(torch.cat(outs, dim=1))
    if return_state:
        return out, h
    return out


def _mamba_forward_fused(p: dict, x: torch.Tensor, mp: MambaParams, *,
                         backend: str, reduce: Callable = _same,
                         reduce_ssm: Callable = _same) -> torch.Tensor:
    """Projections, conv and gating in PyTorch; the discretize + scan core
    in the fused-scan wrapper (``backend="cuda"``) or its plain version
    (``backend="torch"``).  Inference path (no backward)."""
    dt_rank = p["dt_proj"].shape[0]
    xz = _in_proj(p, x)
    x_in, z = xz[:, :, 0], xz[:, :, 1]
    xcv = F.silu(_causal_conv(p, x_in, mp.d_conv))               # (B,S,di) f32
    xdbc = reduce_ssm(xcv @ p["x_proj"].float())
    dt_low, b_ssm, c_ssm = torch.split(
        xdbc, [dt_rank, mp.d_state, mp.d_state], dim=-1)
    dt_raw = dt_low @ p["dt_proj"].float()                        # pre-softplus
    # b_ssm / c_ssm are views with row stride dt_rank + 2N; the kernel
    # takes contiguous rows (2 x B*S*N floats copied)
    args = (xcv, dt_raw, b_ssm.contiguous(), c_ssm.contiguous(),
            p["A_log"].float().contiguous(), p["dt_bias"].float(),
            p["D"].float())
    scan = selective_scan if backend == "cuda" else selective_scan_plain
    y = scan(*args)
    y = y * F.silu(z.float())
    return reduce(_out_proj(p, y, x.dtype))


def init_mamba_state(batch: int, d_model: int, mp: MambaParams,
                     dtype: torch.dtype = torch.float32, *, device) -> dict:
    return {
        "h": torch.zeros((batch, mp.d_inner, mp.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, mp.d_conv - 1, mp.d_inner), dtype=dtype,
                            device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, state: dict, mp: MambaParams,
                 reduce: Callable = _same):
    """One token. x (B, 1, d_model) -> (y (B, 1, d_model), new_state)."""
    xz = _in_proj(p, x)
    x_in, z = xz[:, 0, 0], xz[:, 0, 1]                            # (B, di)
    # conv over [conv_tail ++ x_in]
    w = p["conv_w"].float()
    hist = torch.cat([state["conv"].float(), x_in[:, None].float()], dim=1)
    xc = F.silu(torch.einsum("bcd,cd->bd", hist, w) + p["conv_b"].float())
    a, b, c_ssm = _ssm_inputs(p, xc[:, None, :], mp, reduce)
    h = a[:, 0] * state["h"] + b[:, 0]                            # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0]) + p["D"].float() * xc
    y = y * F.silu(z.float())
    out = reduce(_out_proj(p, y, x.dtype))
    new_state = {"h": h, "conv": hist[:, 1:].to(state["conv"].dtype)}
    return out[:, None, :], new_state
