"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16.  [arXiv:2410.05355; unverified]

Pure Mamba-1 stack: every block is norm -> mamba -> residual (no separate
FFN, d_ff=0 per the assignment).  d_inner = 2*d_model = 8192, dt_rank =
d_model/16 = 256, conv 4.  long_500k runs natively: decode state is O(1) in
sequence length.

Port of `src/repro/configs/falcon_mamba_7b.py` (`full()` :18,
`reduced()` :31): the same values, torch dtypes for jnp ones.
The full model holds 7,272,665,088 parameters (14.5 GB in bf16), so all
64 layers fit one 80 GB card.  The port's `MambaParams` defaults to
``fused_scan="on"``: both configs prefill through the scan kernel (the
reference's `full()` keeps its XLA path).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.nn.mamba import MambaParams
from repro_torch.nn.transformer import LayerSpec, LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="falcon-mamba-7b", n_layers=64, d_model=4096, vocab=65_024,
        d_ff=0,
        period=(LayerSpec(kind="mamba", mlp="none"),),
        rope="none",
        mamba=MambaParams(d_inner=8192, d_state=16, dt_rank=256, d_conv=4,
                          chunk=256),
        norm="rms", act="silu", tie_embeddings=False,
        max_seq=32768,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="falcon-mamba-reduced", n_layers=2, d_model=64, vocab=256,
        d_ff=0,
        period=(LayerSpec(kind="mamba", mlp="none"),),
        rope="none",
        mamba=MambaParams(d_inner=128, d_state=8, dt_rank=8, d_conv=4,
                          chunk=32),
        norm="rms", act="silu",
        dtype=torch.float32, loss_chunk=64, max_seq=64,
    )


ARCH = ArchDef(
    name="falcon-mamba-7b", family="ssm", full=full, reduced=reduced,
    source="arXiv:2410.05355; unverified",
    notes="attention-free Mamba-1; GNNAdvisor technique n/a (no sparse "
          "aggregation; fixed-shape scan) — DESIGN.md §Arch-applicability.")
