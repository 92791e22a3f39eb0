"""Architecture records and the assigned input shapes.

Port of `src/repro/configs/base.py`: `ShapeDef`, `SHAPES`, `ArchDef` with
`supports_long` (:53) and `cell_is_runnable` (:65).  `full()` is the
published configuration, `reduced()` a same-family small one for CPU
tests.  The reference's `input_specs` / `abstract_cache`
(shape stand-ins for the JAX dry-run) have no counterpart: the port builds
a full-size model without allocating on the ``meta`` device
(`repro_torch.models.lm.LMModel.create(device="meta")`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.nn.transformer import LMConfig

__all__ = ["ArchDef", "ShapeDef", "SHAPES", "cell_is_runnable"]


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

    def supports_long(self) -> bool:
        """long_500k needs a sub-quadratic decode: an SSM state or a
        sliding window on some attention slot.  Archs whose period has
        only unwindowed attention are skipped."""
        period = self.full().period
        return any(s.kind == "mamba" or (s.kind == "attn"
                                         and s.window is not None)
                   for s in period)


def cell_is_runnable(arch: ArchDef, shape_name: str) -> tuple:
    if shape_name == "long_500k" and not arch.supports_long():
        return False, ("pure full-attention arch: no sub-quadratic mechanism "
                       "for 524288-token decode (skip per assignment)")
    return True, ""
