"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16, MHA) expert d_ff=1024
vocab=50304, MoE 64e top-8.  [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924]

OLMoE: QK-norm, SwiGLU experts, every layer MoE, rope theta 10000,
untied embeddings.

Port of `src/repro/configs/olmoe_1b_7b.py` (`full()` :16,
`reduced()` :29): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.moe import MoEParams
from repro_torch.nn.transformer import LayerSpec, LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, vocab=50_304,
        n_heads=16, n_kv=16, head_dim=128, d_ff=1024,
        period=(LayerSpec(kind="attn", mlp="moe"),),
        rope="rope", rope_theta=10_000.0, qk_norm=True,
        moe=MoEParams(n_experts=64, topk=8, d_ff=1024,
                      router_norm_topk=False),
        norm="rms", act="silu", tie_embeddings=False,
        max_seq=4096,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="olmoe-reduced", n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=4, head_dim=16, d_ff=64,
        period=(LayerSpec(kind="attn", mlp="moe"),),
        rope="rope", qk_norm=True,
        moe=MoEParams(n_experts=8, topk=4, d_ff=64, router_norm_topk=False),
        norm="rms", act="silu",
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="olmoe-1b-7b", family="moe", full=full, reduced=reduced,
    source="arXiv:2409.02060; hf",
    notes="64 experts top-8 every layer; MHA (kv=16); QK-norm.")
