"""LM model-level API: parameters, and the prefill / decode step factories
the serving driver consumes.

Port of `src/repro/models/lm.py`: `LMModel` (:38), `make_prefill_step`
(:135) and `make_decode_step` (:184), with the reference's step
signatures, ``prefill(params, inputs, pos)`` and ``decode(params, cache,
tok, t)``, and without the mesh and sharding arguments (sharding waits
for ROADMAP Queue 1 item 5) and the train step (the LM training slice,
item 9b).  The step functions run under `torch.no_grad()`.

``backend="cuda"`` prefills the Mamba slots through the hand-written scan
kernel, ``"torch"`` through its plain version (on the card too, for the
agreement checks); attention and MoE run in plain PyTorch either way (the
reference computes them outside any Pallas kernel); decode runs no
kernel.  `lm_params_from_jax` carries a reference parameter pytree
across, for every architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, set_matmul_precision
from repro_torch.nn.mamba import BACKENDS
from repro_torch.nn.transformer import (LMConfig, lm_decode_step, lm_init,
                                        lm_prefill, param_count)

__all__ = ["LMModel", "make_prefill_step", "make_decode_step",
           "lm_params_from_jax"]

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


@dataclasses.dataclass
class LMModel:
    """Config + params bundle."""

    cfg: LMConfig
    params: dict

    @classmethod
    def create(cls, cfg: LMConfig, seed: int = 0, *,
               device="cuda") -> "LMModel":
        """Random weights from a `torch.Generator` seeded with ``seed`` on
        ``device``; ``device="meta"`` builds the shapes alone."""
        set_matmul_precision()
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        return cls(cfg=cfg, params=lm_init(cfg, gen, device=dev))

    @property
    def n_params(self) -> int:
        return param_count(self.params)


def make_prefill_step(cfg: LMConfig, *, backend: str = "cuda"):
    """Prefill: (params, inputs, pos) -> (last-token logits, kvs).
    ``inputs`` tokens (B, S) or embeds (B, S, d); ``pos`` (B, S), or (B,
    3, S) for mrope."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    set_matmul_precision()

    @torch.no_grad()
    def prefill(params, inputs, pos):
        return lm_prefill(params, cfg, inputs, pos, backend=backend)

    return prefill


def make_decode_step(cfg: LMConfig):
    """Decode: (params, cache, token_or_embed, t) -> (logits, cache), the
    cache updated in place; ``t`` the step's position (an int).  Decode
    runs no kernel, so there is no backend to choose."""
    set_matmul_precision()

    @torch.no_grad()
    def decode(params, cache, tok, t):
        return lm_decode_step(params, cfg, cache, tok, t)

    return decode


def _to_torch(x: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    dtype = _TORCH_DTYPE[a.dtype.name]
    if a.dtype.name == "bfloat16":        # numpy-side bf16 has no torch view
        a = a.astype(np.float32)
    return torch.tensor(a).to(device=dev, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_jax(params_np: dict, cfg: LMConfig,
                       device: Optional[str] = "cuda") -> dict:
    """The reference's LM parameter pytree (numpy arrays, or anything
    `np.asarray` takes) as the port's parameters on ``device``: the same
    keys, dtypes and values (tied tables without ``unembed``, float32
    routers, biases, LayerNorm ``b``, fused or separate QKV alike), with
    the blocks' leading ``(R,)`` layer axis unstacked into one dict per
    layer."""
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _to_torch(a, dev))
           for k, v in params_np.items() if k != "blocks"}
    out["blocks"] = [
        tuple(_map(slot, lambda a, r=r: _to_torch(np.asarray(a)[r], dev))
              for slot in params_np["blocks"])
        for r in range(cfg.repeats)]
    return out
