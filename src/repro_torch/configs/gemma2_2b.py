"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

[arXiv:2408.00118; hf:google/gemma-2-2b]

Gemma-2 features: local(4096)/global alternating attention, GeGLU, RMSNorm
pre+post every sub-block, attention logit softcap 50, final logit softcap 30,
embeddings scaled by sqrt(d_model), tied LM head, head_dim=256.

Port of `src/repro/configs/gemma2_2b.py` (`full()` :22,
`reduced()` :35): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.transformer import LayerSpec, LMConfig

_PERIOD = (LayerSpec(kind="attn", mlp="glu", window=4096),   # local
           LayerSpec(kind="attn", mlp="glu", window=None))   # global


def full() -> LMConfig:
    return LMConfig(
        name="gemma2-2b", n_layers=26, d_model=2304, vocab=256_000,
        n_heads=8, n_kv=4, head_dim=256, d_ff=9216,
        period=_PERIOD,
        rope="rope", rope_theta=10_000.0,
        attn_softcap=50.0, final_softcap=30.0,
        norm="rms", post_norm=True, act="gelu",
        embed_scale=math.sqrt(2304), tie_embeddings=True,
        max_seq=8192,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="gemma2-2b-reduced", n_layers=4, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128,
        period=(LayerSpec(kind="attn", mlp="glu", window=32),
                LayerSpec(kind="attn", mlp="glu", window=None)),
        rope="rope", attn_softcap=50.0, final_softcap=30.0,
        norm="rms", post_norm=True, act="gelu",
        embed_scale=8.0, tie_embeddings=True,
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="gemma2-2b", family="dense", full=full, reduced=reduced,
    source="arXiv:2408.00118; hf",
    notes="local+global alternating (4096 window), logit softcaps 50/30, "
          "GeGLU, pre+post RMSNorm, tied embeddings.")
