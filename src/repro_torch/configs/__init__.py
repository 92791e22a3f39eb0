"""Architecture registry: the LM configurations the port runs.

Port of `src/repro/configs/__init__.py`.  Only falcon-mamba-7b is ported
(the pure-Mamba stack); the reference's other nine architectures need
attention and MoE slots, which wait for ROADMAP Queue 1 item 9.

Usage:  from repro_torch.configs import get_arch
        cfg = get_arch("falcon-mamba-7b").full()
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchDef, ShapeDef
from repro_torch.configs.falcon_mamba_7b import ARCH as _falcon_mamba

ARCHS = {a.name: a for a in [_falcon_mamba]}


def get_arch(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown or unported arch {name!r}; ported: "
                       f"{sorted(ARCHS)} (the reference's other "
                       f"architectures wait for ROADMAP Queue 1 item 9)")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchDef", "SHAPES", "ShapeDef", "get_arch"]
