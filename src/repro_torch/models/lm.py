"""LM model-level API: parameters, and the train / prefill / decode step
factories the drivers consume.

Port of `src/repro/models/lm.py`: `LMModel` (:38), `TrainStepFns` (:59),
`make_train_step` (:84), `make_prefill_step` (:135) and
`make_decode_step` (:184), with the reference's step signatures,
``step(params, opt_state, batch)``, ``prefill(params, inputs, pos)`` and
``decode(params, cache, tok, t)``, and without the mesh and sharding
arguments (sharding waits for ROADMAP Queue 1 item 5; `TrainStepFns`'
shardings are None).  Prefill and decode run under `torch.no_grad()`,
the train step with grad enabled.

``backend="cuda"`` prefills the Mamba slots through the hand-written scan
kernel, ``"torch"`` through its plain version (on the card too, for the
agreement checks); attention and MoE run in plain PyTorch either way (the
reference computes them outside any Pallas kernel); decode runs no
kernel.  Training runs no kernel either: the scan kernel has no backward,
as the reference's Pallas scan has none, so `make_train_step` trains the
Mamba slots on the chunked path (``fused_scan="off"``, what the
reference's default ``pallas_scan="off"`` does).  `lm_params_from_jax`
carries a reference parameter pytree across, for every architecture, and
`lm_params_to_jax` carries the port's (or any tree shaped like it:
gradients, moments) back to the reference's stacked layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, set_matmul_precision
from repro_torch.distributed.accumulate import accumulate_gradients
from repro_torch.nn.mamba import BACKENDS
from repro_torch.nn.transformer import (LMConfig, lm_decode_step, lm_init,
                                        lm_loss, lm_prefill, param_count)
from repro_torch.optim.adamw import AdamWConfig, adamw_update, adamw_update_

__all__ = ["LMModel", "TrainStepFns", "make_train_step", "make_prefill_step",
           "make_decode_step", "lm_params_from_jax", "lm_params_to_jax",
           "train_config", "weight_decay_mask"]

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


@dataclasses.dataclass
class TrainStepFns:
    step: Any                 # (params, opt, batch) -> (params, opt, metrics)
    in_shardings: Any = None
    out_shardings: Any = None
    batch_spec: Any = None


def train_config(cfg: LMConfig) -> LMConfig:
    """``cfg`` as training runs it: Mamba slots on the chunked path (the
    scan kernel has no backward)."""
    if cfg.mamba is None or cfg.mamba.fused_scan == "off":
        return cfg
    return dataclasses.replace(cfg, mamba=dataclasses.replace(
        cfg.mamba, fused_scan="off"))


def weight_decay_mask(params: dict) -> dict:
    """Which leaves take weight decay: the reference decays leaves with
    ``ndim >= 2`` and stacks every block leaf on a leading (R,) axis, so
    every block leaf (norms, biases, ``D``, ``dt_bias`` alike) is decayed
    there; the port's per-layer copies are one rank lower, so the rule is
    applied to the reference's shapes."""
    def mask(tree, stacked):
        if isinstance(tree, dict):
            return {k: mask(v, stacked or k == "blocks")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mask(v, stacked) for v in tree)
        return stacked or tree.ndim >= 2
    return mask(params, False)


def make_train_step(cfg: LMConfig, opt: AdamWConfig, *, n_micro: int = 1,
                    donate: bool = True) -> TrainStepFns:
    """The train step: gradients over ``n_micro`` micro-batches (summed
    in float32 when more than one), then AdamW.  ``step(params,
    opt_state, batch)`` returns ``(params, opt_state, metrics)`` with
    ``grad_norm`` and ``lr`` merged into `lm_loss`'s metrics (0-d
    tensors).  ``donate=True`` updates ``params`` and the moments in
    place (the reference donates both buffers); ``donate=False`` returns
    new tensors and leaves the inputs untouched."""
    cfg = train_config(cfg)
    set_matmul_precision()
    update = adamw_update_ if donate else adamw_update

    def loss_fn(params, mb):
        return lm_loss(params, cfg, mb)

    def step(params, opt_state, batch):
        grads, _loss, metrics = accumulate_gradients(loss_fn, params, batch,
                                                     n_micro)
        new_params, new_opt, opt_metrics = update(
            opt, grads, opt_state, params, decay=weight_decay_mask(params))
        return new_params, new_opt, dict(metrics, **opt_metrics)

    return TrainStepFns(step=step)


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


def lm_params_to_jax(params: dict, cfg: LMConfig) -> dict:
    """The inverse of `lm_params_from_jax`: a tree shaped like the port's
    parameters (parameters, gradients or moments) as the reference's
    pytree of float32 numpy arrays, the per-layer block dicts restacked
    on a leading ``(R,)`` axis (bfloat16 leaves widened to float32)."""
    host = lambda t: t.detach().float().cpu().numpy()
    out = {k: _map(v, host) for k, v in params.items() if k != "blocks"}
    blocks = params["blocks"]
    if len(blocks) != cfg.repeats:
        raise ValueError(f"{len(blocks)} repeats of the period, the config "
                         f"has {cfg.repeats}")

    def stack(*layers):
        if isinstance(layers[0], dict):
            return {k: stack(*(l[k] for l in layers)) for k in layers[0]}
        return np.stack([host(t) for t in layers])

    out["blocks"] = tuple(stack(*(rep[s] for rep in blocks))
                          for s in range(len(cfg.period)))
    return out
