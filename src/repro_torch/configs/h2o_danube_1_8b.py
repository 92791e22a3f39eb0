"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000.  [arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base]

Llama+Mistral mix: RMSNorm, SwiGLU, RoPE, sliding-window attention (4096)
on every layer — the Mistral ingredient that makes long_500k decodable with
an O(window) ring-buffer cache.

Port of `src/repro/configs/h2o_danube_1_8b.py` (`full()` :16,
`reduced()` :27): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.transformer import LayerSpec, LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="h2o-danube-1.8b", n_layers=24, d_model=2560, vocab=32_000,
        n_heads=32, n_kv=8, head_dim=80, d_ff=6912,
        period=(LayerSpec(kind="attn", mlp="glu", window=4096),),
        rope="rope", rope_theta=10_000.0,
        norm="rms", act="silu", tie_embeddings=False,
        max_seq=16384,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="h2o-danube-1.8b-reduced", n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128,
        period=(LayerSpec(kind="attn", mlp="glu", window=32),),
        rope="rope", norm="rms", act="silu",
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="h2o-danube-1.8b", family="dense", full=full, reduced=reduced,
    source="arXiv:2401.16818; hf",
    notes="SWA 4096 every layer (Mistral-style); SwiGLU; GQA 32/8.")
