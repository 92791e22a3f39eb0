"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B]

Backbone-only per the assignment: the dynamic-resolution ViT frontend is a
STUB — the caller supplies precomputed patch/text embeddings (B, S, d).
Backbone features kept: M-RoPE with (16, 24, 24) sections over head_dim/2 =
64, QKV bias, SwiGLU, RMSNorm, rope theta 1e6.

Port of `src/repro/configs/qwen2_vl_2b.py` (`full()` :17,
`reduced()` :29): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.transformer import LayerSpec, LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-2b", n_layers=28, d_model=1536, vocab=151_936,
        n_heads=12, n_kv=2, head_dim=128, d_ff=8960,
        period=(LayerSpec(kind="attn", mlp="glu"),),
        rope="mrope", rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24), attn_bias=True,
        norm="rms", act="silu", frontend="embeds",
        max_seq=32768,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen2-vl-reduced", n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128,
        period=(LayerSpec(kind="attn", mlp="glu"),),
        rope="mrope", mrope_sections=(2, 3, 3), attn_bias=True,
        norm="rms", act="silu", frontend="embeds",
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="qwen2-vl-2b", family="vlm", full=full, reduced=reduced,
    source="arXiv:2409.12191; hf",
    notes="M-RoPE (16,24,24), dynamic-resolution ViT frontend stubbed "
          "(precomputed patch embeddings).")
