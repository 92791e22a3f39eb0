"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152.  [arXiv:2402.19173; hf:bigcode/starcoder2-15b]

StarCoder2 details: LayerNorm, plain GELU MLP (no gating), attention + MLP
biases, RoPE theta 1e5, tied embeddings.  Treated as full attention per the
assignment spec ("GQA, RoPE"); long_500k is therefore skipped for this arch.

Port of `src/repro/configs/starcoder2_15b.py` (`full()` :16,
`reduced()` :28): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.transformer import LayerSpec, LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="starcoder2-15b", n_layers=40, d_model=6144, vocab=49_152,
        n_heads=48, n_kv=4, head_dim=128, d_ff=24576,
        period=(LayerSpec(kind="attn", mlp="mlp"),),
        rope="rope", rope_theta=100_000.0, attn_bias=True,
        fused_qkv=False,          # H+2K = 56: not divisible by TP=16
        norm="ln", act="gelu", tie_embeddings=True,
        max_seq=16384,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="starcoder2-15b-reduced", n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, d_ff=256,
        period=(LayerSpec(kind="attn", mlp="mlp"),),
        rope="rope", rope_theta=100_000.0, attn_bias=True,
        norm="ln", act="gelu", tie_embeddings=True,
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="starcoder2-15b", family="dense", full=full, reduced=reduced,
    source="arXiv:2402.19173; hf",
    notes="LayerNorm + biased attention/MLP, plain GELU FFN, RoPE 1e5.")
