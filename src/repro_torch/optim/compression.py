"""Int8 error-feedback gradient compression.

Port of `src/repro/optim/compression.py` (`quantize_int8`,
`dequantize_int8`, `ef_init`, `compress_decompress`, `compressed_psum`),
on tensors, on the tensor's own device.  Error feedback (Karimireddy et
al., 2019) keeps the quantization residual in an accumulator so the
compression error is corrected on later steps.  `torch.round`, like
`jnp.round`, rounds half to even, so the codes are bit-equal to the
reference's.  `compressed_psum` runs inside a rank of a
`repro_torch.distributed.ranks` group, where the reference's named mesh
axis is the group.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.runtime.checkpoint import _leaves, _rebuild

Tree = Any

__all__ = ["quantize_int8", "dequantize_int8", "ef_init",
           "compress_decompress", "compressed_psum"]


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8: returns (q int8, scale f32 0-d)."""
    xf = x.float()
    amax = xf.abs().max().clamp_min(1e-12)
    # divide by a tensor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which can land one ulp away from the division
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(grads: Tree) -> Tree:
    """A float32 zero accumulator beside each leaf of ``grads`` (the nested
    dict / list trees of `optim.adamw`, in its leaf order)."""
    return _rebuild(grads, iter([torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device)
                                 for g in _leaves(grads)]))


def compress_decompress(g: torch.Tensor, e: torch.Tensor):
    """Error-feedback quantize/dequantize round trip for one tensor.

    Returns (g_hat, new_error): g_hat = deq(quant(g + e)), new_error =
    (g + e) - g_hat.
    """
    corrected = g.float() + e
    q, scale = quantize_int8(corrected)
    g_hat = dequantize_int8(q, scale)
    return g_hat, corrected - g_hat


def compressed_psum(grads: Tree, ef: Optional[Tree] = None):
    """Sum ``grads`` over the ranks of the group with int8 error-feedback
    compression; returns ``(totals, new_ef)`` (trees like ``grads``).

    Called on every rank at once (the reference's `shard_map` body).  Per
    leaf: a max-reduce of ``|g + e|`` gives the ranks one shared scale,
    the int8 codes are summed in int32 (no overflow), and each rank keeps
    its own quantization residual: two collectives, about 4x less volume
    than a float32 sum.
    """
    from repro_torch.distributed.ranks import all_reduce_
    if ef is None:
        ef = ef_init(grads)

    def one(g, e):
        corrected = g.float() + e
        # shared scale across the ranks so the int8 sum is well-defined
        amax = all_reduce_(corrected.abs().max().reshape(1), "max")[0]
        scale = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
        q = torch.clamp(torch.round(corrected / scale), -127, 127
                        ).to(torch.int8)
        new_e = corrected - q.float() * scale
        total = all_reduce_(q.to(torch.int32), "sum")
        return total.float() * scale, new_e

    out = [one(g, e) for g, e in zip(_leaves(grads), _leaves(ef))]
    return (_rebuild(grads, iter([t for t, _ in out])),
            _rebuild(grads, iter([e for _, e in out])))
