"""LM assembly, the pure-Mamba subset (falcon-mamba).

Port of `src/repro/nn/transformer.py` (:192-490): `LayerSpec`, `LMConfig`
(the fields a pure-Mamba stack reads; the reference's ``d_ff``, ``rope``,
``act``, ``loss_chunk`` and ``max_seq`` feed only its FFN, attention and
training-loss code and have no counterpart), `lm_init`, `param_count`,
`_embed_in`, `lm_forward`, `lm_prefill`, `init_lm_cache`, `_slot_decode`
and `lm_decode_step`.  Attention, FFN and MoE slots, other norms and
tied embeddings wait for ROADMAP Queue 1 item 9; a config that asks for
them raises `NotImplementedError`.  Mamba layers read no positions, so
the port's functions take none (the reference's ``pos`` / ``t``).

Layout.  The reference stacks every slot's weights on a leading
``(repeats,)`` axis and runs one `lax.scan` over it; the port keeps one
dict per layer, ``params["blocks"][r][s]`` for repeat ``r`` and period
slot ``s``, and runs a Python loop over layers in the same order.  The
decode cache keeps the reference's layout: a tuple over period slots of
``{"h": (R, B, d_inner, N) f32, "conv": (R, B, d_conv-1, d_inner)}``;
`lm_decode_step` writes each step's states into it in place (saving a
second copy of the cache) and returns it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.nn.layers import Initializer, apply_rmsnorm, rmsnorm
from repro_torch.nn.mamba import (MambaParams, init_mamba_state, mamba_decode,
                                  mamba_forward, mamba_init)

__all__ = ["LayerSpec", "LMConfig", "lm_init", "lm_forward", "lm_prefill",
           "lm_decode_step", "init_lm_cache", "param_count"]

_NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 9)"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One slot of the repeating layer period."""

    kind: str = "attn"            # "attn" | "mamba"
    mlp: str = "glu"              # "glu" | "mlp" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    period: tuple = (LayerSpec(),)
    norm: str = "rms"
    mamba: Optional[MambaParams] = None
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        for spec in self.period:
            if spec.kind != "mamba" or spec.mlp != "none":
                raise NotImplementedError(
                    f"{self.name}: slot {spec} — attention, FFN and MoE "
                    f"slots are {_NOT_PORTED}")
        if self.norm != "rms" or self.tie_embeddings:
            raise NotImplementedError(
                f"{self.name}: norm={self.norm!r} tie_embeddings="
                f"{self.tie_embeddings} — only RMS norms and a separate "
                f"unembedding are ported; the rest is {_NOT_PORTED}")
        if self.mamba is None:
            raise ValueError(f"{self.name}: Mamba slots need `mamba`")
        if self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not "
                             f"a multiple of the period {len(self.period)}")

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.period)


def _slot_init(cfg: LMConfig, init: Initializer) -> dict:
    return {"norm1": rmsnorm(init, cfg.d_model),
            "mamba": mamba_init(init, cfg.d_model, cfg.mamba)}


def lm_init(cfg: LMConfig, generator: Optional[torch.Generator], *,
            device) -> dict:
    """The whole LM's parameters in ``cfg.dtype`` on ``device``
    (``"meta"`` builds shapes alone).  ``generator`` lives on ``device``
    (unused on ``meta``)."""
    init = Initializer(generator, device=device, dtype=cfg.dtype)
    return {
        "embed": init.weight((cfg.vocab, cfg.d_model), scale=1.0),
        "unembed": init.weight((cfg.d_model, cfg.vocab),
                               scale=1.0 / math.sqrt(cfg.d_model)),
        "final_norm": rmsnorm(init, cfg.d_model),
        "blocks": [tuple(_slot_init(cfg, init) for _ in cfg.period)
                   for _ in range(cfg.repeats)],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: dict) -> int:
    return sum(x.numel() for x in _leaves(params))


def _embed_in(cfg: LMConfig, params: dict, tokens: torch.Tensor
              ) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.dtype)


def _logits(params: dict, last: torch.Tensor) -> torch.Tensor:
    return last.float() @ params["unembed"].float()


def _slot_forward(cfg: LMConfig, bp: dict, x: torch.Tensor, *,
                  backend: str) -> torch.Tensor:
    h = apply_rmsnorm(bp["norm1"], x)
    return x + mamba_forward(bp["mamba"], h, cfg.mamba, backend=backend)


def lm_forward(params: dict, cfg: LMConfig, tokens: torch.Tensor, *,
               backend: str = "cuda") -> torch.Tensor:
    """Run the trunk: tokens (B, S) int -> hidden (B, S, d_model)."""
    x = _embed_in(cfg, params, tokens)
    for slots in params["blocks"]:
        for bp in slots:
            x = _slot_forward(cfg, bp, x, backend=backend)
    return apply_rmsnorm(params["final_norm"], x)


def lm_prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor, *,
               backend: str = "cuda"):
    """Prefill pass: returns (last_token_logits (B, V) f32, kvs).

    ``kvs`` holds one None per period slot: Mamba slots give no KV, as in
    the reference, and serving decodes from step 0 (`launch/serve.py`);
    there is no prefill-to-decode hand-off."""
    hidden = lm_forward(params, cfg, tokens, backend=backend)
    return (_logits(params, hidden[:, -1, :]),
            tuple(None for _ in cfg.period))


def init_lm_cache(cfg: LMConfig, batch: int,
                  dtype: torch.dtype = torch.bfloat16, *, device) -> tuple:
    """Decode cache: a tuple over period slots of stacked ``(R, ...)``
    Mamba states and conv tails (O(1) in sequence length)."""
    slots = []
    for _ in cfg.period:
        one = init_mamba_state(batch, cfg.d_model, cfg.mamba, dtype=dtype,
                               device=device)
        slots.append({k: v[None].repeat((cfg.repeats,) + (1,) * v.dim())
                      for k, v in one.items()})
    return tuple(slots)


def _slot_decode(cfg: LMConfig, bp: dict, cache: dict, x: torch.Tensor):
    h = apply_rmsnorm(bp["norm1"], x)
    h, new_cache = mamba_decode(bp["mamba"], h, cache, cfg.mamba)
    return x + h, new_cache


def lm_decode_step(params: dict, cfg: LMConfig, cache: tuple,
                   token: torch.Tensor):
    """One decode step for the whole batch: token (B,) int.

    Returns (logits (B, V) f32, cache), the cache updated in place."""
    x = _embed_in(cfg, params, token[:, None])
    for r, slots in enumerate(params["blocks"]):
        for bp, slot_cache in zip(slots, cache):
            layer = {k: v[r] for k, v in slot_cache.items()}
            x, new = _slot_decode(cfg, bp, layer, x)
            for k, v in new.items():
                slot_cache[k][r].copy_(v)
    x = apply_rmsnorm(params["final_norm"], x)
    return _logits(params, x[:, 0]), cache
