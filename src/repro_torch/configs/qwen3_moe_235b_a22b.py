"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128e top-8.
[hf:Qwen/Qwen3-235B-A22B (dims per assignment); hf:Qwen/Qwen3-30B-A3B]

Qwen3 features: QK-RMSNorm, SwiGLU experts, every layer MoE (no shared
expert), rope theta 1e6, norm_topk_prob=True.

Port of `src/repro/configs/qwen3_moe_235b_a22b.py` (`full()` :17,
`reduced()` :31): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.moe import MoEParams
from repro_torch.nn.transformer import LayerSpec, LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, vocab=151_936,
        n_heads=64, n_kv=4, head_dim=128, d_ff=1536,
        period=(LayerSpec(kind="attn", mlp="moe"),),
        rope="rope", rope_theta=1_000_000.0, qk_norm=True,
        fused_qkv=False,          # H+2K = 72: not divisible by TP=16
        moe=MoEParams(n_experts=128, topk=8, d_ff=1536,
                      router_norm_topk=True),
        norm="rms", act="silu", tie_embeddings=False,
        max_seq=32768,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-reduced", n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, d_ff=64,
        period=(LayerSpec(kind="attn", mlp="moe"),),
        rope="rope", qk_norm=True,
        moe=MoEParams(n_experts=8, topk=4, d_ff=64, router_norm_topk=True),
        norm="rms", act="silu",
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="qwen3-moe-235b-a22b", family="moe", full=full, reduced=reduced,
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="128 experts top-8 every layer; QK-norm; GQA 64/4. The paper's "
          "group-based workload technique maps onto the expert dispatch "
          "(DESIGN.md §5).")
