"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

[arXiv:2408.00118; hf:google/gemma-2-9b]  Same feature set as gemma2-2b.

Port of `src/repro/configs/gemma2_9b.py` (`full()` :18,
`reduced()` :31): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.transformer import LayerSpec, LMConfig

_PERIOD = (LayerSpec(kind="attn", mlp="glu", window=4096),
           LayerSpec(kind="attn", mlp="glu", window=None))


def full() -> LMConfig:
    return LMConfig(
        name="gemma2-9b", n_layers=42, d_model=3584, vocab=256_000,
        n_heads=16, n_kv=8, head_dim=256, d_ff=14336,
        period=_PERIOD,
        rope="rope", rope_theta=10_000.0,
        attn_softcap=50.0, final_softcap=30.0,
        norm="rms", post_norm=True, act="gelu",
        embed_scale=math.sqrt(3584), tie_embeddings=True,
        max_seq=8192,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="gemma2-9b-reduced", n_layers=4, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, d_ff=192,
        period=(LayerSpec(kind="attn", mlp="glu", window=32),
                LayerSpec(kind="attn", mlp="glu", window=None)),
        rope="rope", attn_softcap=50.0, final_softcap=30.0,
        norm="rms", post_norm=True, act="gelu",
        embed_scale=8.0, tie_embeddings=True,
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="gemma2-9b", family="dense", full=full, reduced=reduced,
    source="arXiv:2408.00118; hf",
    notes="local+global alternating, logit softcaps, GeGLU, tied embeddings.")
