"""Architecture records and the assigned input shapes.

Port of `src/repro/configs/base.py`: `ShapeDef`, `SHAPES` and `ArchDef`.
`full()` is the published configuration, `reduced()` a same-family small
one for CPU tests.  The reference's `input_specs` / `abstract_cache`
(shape stand-ins for the JAX dry-run) have no counterpart: the port builds
a full-size model without allocating on the ``meta`` device
(`repro_torch.models.lm.LMModel.create(device="meta")`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.nn.transformer import LMConfig

__all__ = ["ArchDef", "ShapeDef", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeDef("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeDef("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeDef("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeDef("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    full: Callable[[], LMConfig]
    reduced: Callable[[], LMConfig]
    source: str = ""
    notes: str = ""
