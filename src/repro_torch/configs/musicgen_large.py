"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192 vocab=2048.
[arXiv:2306.05284; hf:facebook/musicgen-large]

The EnCodec modality frontend (4 codebooks, delay pattern) is a STUB per the
assignment: the caller supplies precomputed frame embeddings (B, S, d);
labels remain codebook-token ids over the 2048-entry vocab.  The backbone is
a pre-LN transformer with LayerNorm, GELU MLP, MHA, and sinusoidal positions
(no RoPE), matching the audiocraft implementation.

Port of `src/repro/configs/musicgen_large.py` (`full()` :20,
`reduced()` :31): the same values, torch dtypes for jnp ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.transformer import LayerSpec, LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="musicgen-large", n_layers=48, d_model=2048, vocab=2048,
        n_heads=32, n_kv=32, head_dim=64, d_ff=8192,
        period=(LayerSpec(kind="attn", mlp="mlp"),),
        rope="none", posemb="sinusoidal", norm="ln", act="gelu",
        frontend="embeds", tie_embeddings=False,
        max_seq=4096,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="musicgen-large-reduced", n_layers=2, d_model=64, vocab=128,
        n_heads=4, n_kv=4, head_dim=16, d_ff=128,
        period=(LayerSpec(kind="attn", mlp="mlp"),),
        rope="none", posemb="sinusoidal", norm="ln", act="gelu",
        frontend="embeds", tie_embeddings=False,
        dtype=torch.float32, q_chunk=32, kv_chunk=32, loss_chunk=64,
        max_seq=64,
    )


ARCH = ArchDef(
    name="musicgen-large", family="audio", full=full, reduced=reduced,
    source="arXiv:2306.05284; hf",
    notes="EnCodec frontend stubbed (precomputed frame embeddings); "
          "MHA (kv=32), LayerNorm+GELU, sinusoidal positions.")
