"""Architecture registry: the ten LM architectures (+ the paper's own
GCN/GIN benchmark configs in `paper_gnn`).

Port of `src/repro/configs/__init__.py`: the same archs in the same
order, `get_arch` and `arch_names`.  The reference's `input_specs` /
`abstract_cache` have no counterpart (the ``meta`` device stands in,
`configs/base.py`).

Usage:  from repro_torch.configs import get_arch
        cfg = get_arch("gemma2-9b").full()
"""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, ArchDef, ShapeDef,
                                      cell_is_runnable)
from repro_torch.configs.falcon_mamba_7b import ARCH as _falcon_mamba
from repro_torch.configs.gemma2_2b import ARCH as _gemma2_2b
from repro_torch.configs.gemma2_9b import ARCH as _gemma2_9b
from repro_torch.configs.h2o_danube_1_8b import ARCH as _danube
from repro_torch.configs.jamba_v0_1_52b import ARCH as _jamba
from repro_torch.configs.musicgen_large import ARCH as _musicgen
from repro_torch.configs.olmoe_1b_7b import ARCH as _olmoe
from repro_torch.configs.qwen2_vl_2b import ARCH as _qwen2vl
from repro_torch.configs.qwen3_moe_235b_a22b import ARCH as _qwen3moe
from repro_torch.configs.starcoder2_15b import ARCH as _starcoder2

ARCHS = {a.name: a for a in [
    _musicgen, _gemma2_2b, _gemma2_9b, _starcoder2, _danube,
    _jamba, _qwen3moe, _olmoe, _qwen2vl, _falcon_mamba,
]}


def get_arch(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def arch_names() -> list:
    return list(ARCHS)


__all__ = ["ARCHS", "ArchDef", "SHAPES", "ShapeDef", "arch_names",
           "cell_is_runnable", "get_arch"]
