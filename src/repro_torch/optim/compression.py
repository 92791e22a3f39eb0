"""Int8 error-feedback gradient compression: the single-device half.

Port of `src/repro/optim/compression.py` (`quantize_int8`,
`dequantize_int8`, `ef_init`, `compress_decompress`), on tensors, on the
tensor's own device.  Error feedback (Karimireddy et al., 2019) keeps the
quantization residual in an accumulator so the compression error is
corrected on later steps.  `torch.round`, like `jnp.round`, rounds half to
even, so the codes are bit-equal to the reference's.

`compressed_psum` (the int8 all-reduce with a shared scale) is not ported
here: it needs a named mesh axis, that is more than one device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.runtime.checkpoint import _leaves, _rebuild

Tree = Any

__all__ = ["quantize_int8", "dequantize_int8", "ef_init",
           "compress_decompress"]


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
