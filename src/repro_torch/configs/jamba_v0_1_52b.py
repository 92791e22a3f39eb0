"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  [arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]

Jamba interleave (HF config): attn_layer_period=8, attn_layer_offset=4
(1 attention per 8 layers, the 1:7 Mamba:attention ratio); expert_layer_
period=2, expert_layer_offset=1 (MoE replaces the FFN on every odd layer).
No positional encoding (the SSM layers carry position).  Mamba: d_inner =
2*d_model = 8192, d_state 16, conv 4, dt_rank 256.

Port of `src/repro/configs/jamba_v0_1_52b.py` (`full()` :29,
`reduced()` :43): the same values, torch dtypes for jnp ones.
The full model holds 51,570,315,264 parameters (103.1 GB in bf16, more
than one 80 GB card); one period (8 layers) holds 13,295,235,072.  The
Mamba slots prefill through the scan kernel (``fused_scan="on"``, the
port's default).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.mamba import MambaParams
from repro_torch.nn.moe import MoEParams
from repro_torch.nn.transformer import LayerSpec, LMConfig


def _period():
    slots = []
    for s in range(8):
        kind = "attn" if s % 8 == 4 else "mamba"
        mlp = "moe" if s % 2 == 1 else "glu"
        slots.append(LayerSpec(kind=kind, mlp=mlp))
    return tuple(slots)


def full() -> LMConfig:
    return LMConfig(
        name="jamba-v0.1-52b", n_layers=32, d_model=4096, vocab=65_536,
        n_heads=32, n_kv=8, head_dim=128, d_ff=14336,
        period=_period(),
        rope="none",
        moe=MoEParams(n_experts=16, topk=2, d_ff=14336),
        mamba=MambaParams(d_inner=8192, d_state=16, dt_rank=256, d_conv=4,
                          chunk=256),
        norm="rms", act="silu", tie_embeddings=False,
        max_seq=32768,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="jamba-v0.1-52b-reduced", n_layers=8, d_model=64, vocab=256,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128,
        period=_period(),
        rope="none",
        moe=MoEParams(n_experts=4, topk=2, d_ff=96),
        mamba=MambaParams(d_inner=128, d_state=8, dt_rank=8, d_conv=4,
                          chunk=32),
        norm="rms", act="silu",
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="jamba-v0.1-52b", family="hybrid", full=full, reduced=reduced,
    source="arXiv:2403.19887; hf",
    notes="Mamba+attn 1:7 interleave; MoE every 2nd layer (16e top-2); "
          "no positional encoding; long_500k runs (SSM-dominated).")
