"""Device selection and numeric settings shared by the port's entry points.

Entry points run on the card by default (``device="cuda"``).  On a machine
without CUDA they raise instead of silently running on the CPU; the caller
opts into the CPU with ``device="cpu"`` (the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_matmul_precision"]


def resolve_device(device=None) -> torch.device:
    """``device`` (default "cuda") as a concrete `torch.device` ("cuda"
    becomes "cuda:<current>"); raises when CUDA is asked for and
    `torch.cuda.is_available()` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_matmul_precision() -> None:
    """Keep the reference's "accumulate in float32" rule for the dense
    projections (`models/gnn.py:_mmul`): no TF32 for float32 products and
    no reduced-precision reductions for bfloat16 / float16 products.
    These are process-wide PyTorch switches; the model and the serving
    engine set them when they are built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
