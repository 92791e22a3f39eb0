"""LM assembly: one definition covering all ten architectures (dense GQA,
local/global alternation, sliding windows, logit softcaps, MoE,
Mamba-only, Mamba+attention hybrid, the M-RoPE VLM backbone, the audio
LM).

Port of `src/repro/nn/transformer.py`: `LayerSpec` / `LMConfig` (:51-136,
every field, the training-only ones too), `lm_init` (:192), `param_count`,
`_sinusoidal` (:228), `_slot_forward` (:236), `_embed_in` (:302),
`_unembed_w` (:314), `lm_forward` (:320), `init_lm_cache` (:397),
`lm_prefill` (:415), `_slot_decode` (:432) and `lm_decode_step` (:457),
and the training half: `_maybe_remat` (:293) and `lm_loss` (:376).

Layout.  The reference stacks every slot's weights on a leading
``(repeats,)`` axis and runs one `lax.scan` over it; the port keeps one
dict per layer, ``params["blocks"][r][s]`` for repeat ``r`` and period
slot ``s``, and runs a Python loop over the layers in the same order.
Prefill's ``kvs`` and the decode cache keep the reference's stacked
layout: a tuple over period slots, an attention slot's ``(k, v)`` /
``{"k", "v"}`` of shape ``(R, B, S, K, hd)``, a Mamba slot's ``None`` /
``{"h": (R, B, d_inner, N) f32, "conv": (R, B, d_conv-1, d_inner)}``.
`lm_decode_step` updates the cache in place and returns it.

``backend`` picks the Mamba slots' scan: ``"cuda"`` the hand-written
kernel (CUDA tensors only), ``"torch"`` its plain version.  Attention
and MoE run in plain PyTorch on either backend: the reference computes
them outside any Pallas kernel.

Remat.  The reference checkpoints its scan body, one repeat of the
period; the port wraps the same unit in `torch.utils.checkpoint`
(non-reentrant) when grad mode is on: ``remat="full"`` saves only the
repeat's input, ``"dots"`` also the outputs of the matrix products with
no batch dimensions (``aten.mm`` / ``aten.addmm``, the analogue of
``dots_with_no_batch_dims_saveable``), ``"none"`` checkpoints nothing.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.nn.attention import (AttnParams, attention_axes,
                                      attention_decode, attention_forward,
                                      attention_init, init_cache)
from repro_torch.nn.layers import (DEFAULT_RULES, Initializer,
                                   PartitionSpec, ShardingRules,
                                   apply_glu_mlp, apply_layernorm, apply_mlp,
                                   apply_rmsnorm, gelu_tanh, glu_mlp,
                                   glu_mlp_axes, layernorm, mlp, mlp_axes,
                                   norm_axes, rmsnorm)
from repro_torch.nn.losses import chunked_softmax_xent
from repro_torch.nn.mamba import (MambaParams, init_mamba_state, mamba_axes,
                                  mamba_decode, mamba_forward, mamba_init)
from repro_torch.nn.moe import MoEParams, moe_apply, moe_axes, moe_init

__all__ = ["LayerSpec", "LMConfig", "lm_init", "lm_param_specs",
           "lm_forward", "lm_loss", "lm_prefill", "lm_decode_step",
           "init_lm_cache", "param_count"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One slot of the repeating layer period."""

    kind: str = "attn"            # "attn" | "mamba"
    mlp: str = "glu"              # "glu" | "mlp" | "moe" | "none"
    window: Optional[int] = None  # sliding-window width for this slot


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # attention (ignored by pure-mamba archs)
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    # dense FFN width (per-expert width for MoE slots comes from `moe`)
    d_ff: int = 0
    period: tuple = (LayerSpec(),)
    # positional / attention details
    rope: str = "rope"            # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    posemb: str = "none"          # "none" | "sinusoidal" (musicgen)
    mrope_sections: tuple = (16, 24, 24)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False
    attn_bias: bool = False
    query_scale: Optional[float] = None
    fused_qkv: bool = False
    # norms / activations
    norm: str = "rms"             # "rms" | "ln"
    post_norm: bool = False       # gemma2-style post-block norms
    act: str = "silu"             # "silu" | "gelu" (tanh approximation)
    # sub-block params
    moe: Optional[MoEParams] = None
    mamba: Optional[MambaParams] = None
    # embedding
    embed_scale: float = 1.0      # gemma: sqrt(d_model)
    tie_embeddings: bool = False
    frontend: str = "tokens"      # "tokens" | "embeds" (audio/vlm stubs)
    # training details
    aux_loss_weight: float = 0.01
    z_loss: float = 1e-4
    dtype: torch.dtype = torch.bfloat16
    remat: str = "full"           # "full" | "dots" | "none"
    seq_shard_carry: bool = False
    q_chunk: int = 512
    kv_chunk: int = 512
    causal_mode: str = "flash"    # | "masked_full" | "triangle"
    loss_chunk: int = 512
    # serving
    max_seq: int = 4096

    def __post_init__(self):
        if self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not "
                             f"a multiple of the period {len(self.period)}")

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.period)

    def attn_params(self, spec: LayerSpec) -> AttnParams:
        return AttnParams(
            n_heads=self.n_heads, n_kv=self.n_kv, head_dim=self.head_dim,
            rope=self.rope, rope_theta=self.rope_theta,
            mrope_sections=self.mrope_sections, window=spec.window,
            softcap=self.attn_softcap, qk_norm=self.qk_norm,
            bias=self.attn_bias, query_scale=self.query_scale,
            fused_qkv=self.fused_qkv)

    @property
    def activation(self):
        return F.silu if self.act == "silu" else gelu_tanh


def _norm_init(cfg: LMConfig, init: Initializer, dim: int) -> dict:
    return rmsnorm(init, dim) if cfg.norm == "rms" else layernorm(init, dim)


def _apply_norm(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return apply_rmsnorm(p, x) if cfg.norm == "rms" else apply_layernorm(p, x)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _slot_init(cfg: LMConfig, spec: LayerSpec, init: Initializer) -> dict:
    p = {"norm1": _norm_init(cfg, init, cfg.d_model)}
    if spec.kind == "attn":
        p["attn"] = attention_init(init, cfg.d_model, cfg.attn_params(spec))
    else:
        p["mamba"] = mamba_init(init, cfg.d_model, cfg.mamba)
    if cfg.post_norm:
        p["post1"] = _norm_init(cfg, init, cfg.d_model)
    if spec.mlp != "none":
        p["norm2"] = _norm_init(cfg, init, cfg.d_model)
        if spec.mlp == "glu":
            p["ffn"] = glu_mlp(init, cfg.d_model, cfg.d_ff)
        elif spec.mlp == "mlp":
            p["ffn"] = mlp(init, cfg.d_model, cfg.d_ff)
        elif spec.mlp == "moe":
            p["ffn"] = moe_init(init, cfg.d_model, cfg.moe)
        else:
            raise ValueError(spec.mlp)
        if cfg.post_norm:
            p["post2"] = _norm_init(cfg, init, cfg.d_model)
    return p


def lm_init(cfg: LMConfig, generator: Optional[torch.Generator], *,
            device, dtype: Optional[torch.dtype] = None) -> dict:
    """The whole LM's parameters in ``dtype`` (default ``cfg.dtype``; MoE
    routers float32) on ``device`` (``"meta"`` builds shapes alone).
    ``generator`` lives on ``device`` (unused on ``meta``).  Tied
    embeddings (token frontend) draw the table at 1/sqrt(d) and keep no
    ``unembed``."""
    init = Initializer(generator, device=device, dtype=dtype or cfg.dtype)
    p = {}
    if cfg.frontend == "tokens":
        e_scale = 1.0 / math.sqrt(cfg.d_model) if cfg.tie_embeddings else 1.0
        p["embed"] = init.weight((cfg.vocab, cfg.d_model), scale=e_scale)
    if not (cfg.tie_embeddings and cfg.frontend == "tokens"):
        p["unembed"] = init.weight((cfg.d_model, cfg.vocab),
                                   scale=1.0 / math.sqrt(cfg.d_model))
    p["final_norm"] = _norm_init(cfg, init, cfg.d_model)
    p["blocks"] = [tuple(_slot_init(cfg, spec, init) for spec in cfg.period)
                   for _ in range(cfg.repeats)]
    return p


def _slot_axes(cfg: LMConfig, spec: LayerSpec) -> dict:
    """Logical axes of `_slot_init`'s leaves."""
    ax = {"norm1": norm_axes(cfg.norm)}
    if spec.kind == "attn":
        ax["attn"] = attention_axes(cfg.attn_params(spec))
    else:
        ax["mamba"] = mamba_axes(cfg.mamba)
    if cfg.post_norm:
        ax["post1"] = norm_axes(cfg.norm)
    if spec.mlp != "none":
        ax["norm2"] = norm_axes(cfg.norm)
        if spec.mlp == "glu":
            ax["ffn"] = glu_mlp_axes()
        elif spec.mlp == "mlp":
            ax["ffn"] = mlp_axes()
        elif spec.mlp == "moe":
            ax["ffn"] = moe_axes(cfg.moe)
        else:
            raise ValueError(spec.mlp)
        if cfg.post_norm:
            ax["post2"] = norm_axes(cfg.norm)
    return ax


def lm_param_specs(cfg: LMConfig,
                   rules: ShardingRules = DEFAULT_RULES) -> dict:
    """The `PartitionSpec` of every leaf of `lm_init`'s parameters, in
    the same tree: the reference's specs (`src/repro/nn/transformer.py:192`
    `lm_init`).  The reference stacks each block leaf on a leading
    ``"layers"`` dim; a port block leaf is one layer, so its spec is the
    reference's without that first entry."""
    def block(axes: dict) -> dict:
        return {k: block(v) if isinstance(v, dict)
                else PartitionSpec(*rules.spec("layers", *v)[1:])
                for k, v in axes.items()}

    s = {}
    if cfg.frontend == "tokens":
        s["embed"] = rules.spec("vocab", "embed")
    if not (cfg.tie_embeddings and cfg.frontend == "tokens"):
        s["unembed"] = rules.spec("embed", "vocab")
    s["final_norm"] = {k: rules.spec(*v)
                       for k, v in norm_axes(cfg.norm).items()}
    s["blocks"] = [tuple(block(_slot_axes(cfg, spec)) for spec in cfg.period)
                   for _ in range(cfg.repeats)]
    return s


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


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _sinusoidal(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """pos (B, S) -> (B, S, dim) float32 sinusoidal embedding."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    ang = pos[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ffn(cfg: LMConfig, spec: LayerSpec, bp: dict, x: torch.Tensor):
    """The slot's FFN half (pre-norm, FFN, post-norm, residual); returns
    (x, aux)."""
    if spec.mlp == "none":
        return x, None
    aux = None
    h = _apply_norm(cfg, bp["norm2"], x)
    if spec.mlp == "glu":
        h = apply_glu_mlp(bp["ffn"], h, act=cfg.activation)
    elif spec.mlp == "mlp":
        h = apply_mlp(bp["ffn"], h, act=cfg.activation)
    else:
        h, aux, _dropped = moe_apply(bp["ffn"], h, cfg.moe)
    if cfg.post_norm:
        h = _apply_norm(cfg, bp["post2"], h)
    return x + h, aux


def _slot_forward(cfg: LMConfig, spec: LayerSpec, bp: dict, x: torch.Tensor,
                  pos: torch.Tensor, *, backend: str):
    """One layer forward.  Returns (x, aux, kv): ``kv`` the attention
    slot's (k, v), None for a Mamba slot; ``aux`` the MoE load-balance
    loss, None without MoE."""
    h = _apply_norm(cfg, bp["norm1"], x)
    kv = None
    if spec.kind == "attn":
        h, kv = attention_forward(bp["attn"], cfg.attn_params(spec), h, pos,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                  causal_mode=cfg.causal_mode, return_kv=True)
    else:
        h = mamba_forward(bp["mamba"], h, cfg.mamba, backend=backend)
    if cfg.post_norm:
        h = _apply_norm(cfg, bp["post1"], h)
    x, aux = _ffn(cfg, spec, bp, x + h)
    return x, aux, kv


def _period_forward(cfg: LMConfig, slots: tuple, x: torch.Tensor,
                    pos: torch.Tensor, *, backend: str):
    """One repeat of the period, the unit remat checkpoints.  Returns
    (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, bp in zip(cfg.period, slots):
        x, a, _ = _slot_forward(cfg, spec, bp, x, pos, backend=backend)
        if a is not None:
            aux = aux + a
    return x, aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products with no batch dimensions, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg: LMConfig, fn):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    else:
        raise ValueError(f"remat must be 'full', 'dots' or 'none', got "
                         f"{cfg.remat!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _embed_in(cfg: LMConfig, params: dict, inputs: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    if cfg.frontend == "tokens":
        x = params["embed"][inputs.long()].to(cfg.dtype)
    else:
        x = inputs.to(cfg.dtype)
    return _embed_post(cfg, x, pos)


def _embed_post(cfg: LMConfig, x: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """The embedding's scale and positional term, after the lookup."""
    # the scale is rounded to the model dtype first, as in the reference
    x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype, device=x.device)
    if cfg.posemb == "sinusoidal":
        pos1d = pos if pos.dim() == 2 else pos[:, 0]
        x = x + _sinusoidal(pos1d, cfg.d_model).to(cfg.dtype)
    return x


def _unembed_w(cfg: LMConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings and cfg.frontend == "tokens":
        return params["embed"].T
    return params["unembed"]


def _logits(cfg: LMConfig, params: dict, last: torch.Tensor) -> torch.Tensor:
    logits = last.float() @ _unembed_w(cfg, params).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def lm_forward(params: dict, cfg: LMConfig, inputs: torch.Tensor,
               pos: torch.Tensor, *, backend: str = "cuda",
               collect_kv: bool = False):
    """Run the trunk.  Returns (hidden (B,S,d), aux_loss, kvs | None).

    ``inputs``: tokens (B,S) int for ``frontend="tokens"``, else embeds
    (B,S,d).  ``pos``: (B,S) int, or (B,3,S) for mrope.  Without
    ``collect_kv`` and under grad mode, each repeat of the period is
    checkpointed as ``cfg.remat`` says."""
    x = _embed_in(cfg, params, inputs, pos)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_kv:
        body = functools.partial(_period_forward, cfg, backend=backend)
        if torch.is_grad_enabled():
            body = _maybe_remat(cfg, body)
        for slots in params["blocks"]:
            x, a = body(slots, x, pos)
            aux = aux + a
        return _apply_norm(cfg, params["final_norm"], x), aux, None
    per_slot = [[] for _ in cfg.period]
    for slots in params["blocks"]:
        for s, (spec, bp) in enumerate(zip(cfg.period, slots)):
            x, a, kv = _slot_forward(cfg, spec, bp, x, pos, backend=backend)
            if a is not None:
                aux = aux + a
            per_slot[s].append(kv)
    x = _apply_norm(cfg, params["final_norm"], x)
    kvs = tuple(None if spec.kind != "attn" else
                tuple(torch.stack(leaf) for leaf in zip(*got))
                for spec, got in zip(cfg.period, per_slot))
    return x, aux, kvs


def lm_loss(params: dict, cfg: LMConfig, batch: dict):
    """batch: {"tokens"|"embeds", "labels", "pos", optional "mask"}.

    The trunk (remat per `_maybe_remat` under grad mode), then the
    chunked cross-entropy of the final hidden states against the
    unembedding, plus ``aux_loss_weight`` times the MoE load-balance
    loss.  Returns (loss, metrics): ``xent``, ``accuracy``, ``tokens``,
    ``aux_loss``, ``loss``."""
    inputs = batch["tokens"] if cfg.frontend == "tokens" else batch["embeds"]
    hidden, aux, _ = lm_forward(params, cfg, inputs, batch["pos"])
    xent, metrics = chunked_softmax_xent(
        hidden, _unembed_w(cfg, params), batch["labels"],
        mask=batch.get("mask"), chunk=cfg.loss_chunk, z_loss=cfg.z_loss,
        logit_softcap=cfg.final_softcap)
    loss = xent + cfg.aux_loss_weight * aux
    return loss, dict(metrics, aux_loss=aux, loss=loss)


def lm_prefill(params: dict, cfg: LMConfig, inputs: torch.Tensor,
               pos: torch.Tensor, *, backend: str = "cuda"):
    """Prefill pass: returns (last-token logits (B, V) f32, kvs).

    ``kvs`` mirrors the period: attention slots give (k, v), each (R, B,
    S, K, hd) in the model dtype; Mamba slots give None (serving decodes
    from step 0, `launch/serve.py`, as in the reference)."""
    hidden, _aux, kvs = lm_forward(params, cfg, inputs, pos, backend=backend,
                                   collect_kv=True)
    return _logits(cfg, params, hidden[:, -1, :]), kvs


# ---------------------------------------------------------------------------
# serving: single-token decode with stacked caches
# ---------------------------------------------------------------------------

def init_lm_cache(cfg: LMConfig, batch: int, max_seq: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16, *, device) -> tuple:
    """Decode cache: a tuple over period slots; attention slots hold
    stacked (R, B, S_c, K, hd) ring / linear KV buffers (``max_seq``,
    default ``cfg.max_seq``), Mamba slots stacked (R, B, d_inner, N)
    states and conv tails."""
    S = max_seq or cfg.max_seq
    R = cfg.repeats
    slots = []
    for spec in cfg.period:
        if spec.kind == "attn":
            one = init_cache(batch, cfg.attn_params(spec), S, dtype=dtype,
                             device="meta")
        else:
            one = init_mamba_state(batch, cfg.d_model, cfg.mamba, dtype=dtype,
                                   device="meta")
        slots.append({k: torch.zeros((R,) + tuple(v.shape), dtype=v.dtype,
                                     device=device) for k, v in one.items()})
    return tuple(slots)


def _slot_decode(cfg: LMConfig, spec: LayerSpec, bp: dict, cache: dict,
                 x: torch.Tensor, t: int, pos: torch.Tensor) -> torch.Tensor:
    """One layer's decode step; writes the layer's cache (views into the
    stacked cache) in place."""
    h = _apply_norm(cfg, bp["norm1"], x)
    if spec.kind == "attn":
        h, _ = attention_decode(bp["attn"], cfg.attn_params(spec), h, cache,
                                t, pos)
    else:
        h, new = mamba_decode(bp["mamba"], h, cache, cfg.mamba)
        for k, v in new.items():
            cache[k].copy_(v)
    if cfg.post_norm:
        h = _apply_norm(cfg, bp["post1"], h)
    return _ffn(cfg, spec, bp, x + h)[0]


def lm_decode_step(params: dict, cfg: LMConfig, cache: tuple,
                   token_or_embed: torch.Tensor, t: int):
    """One decode step for the whole batch: token (B,) int (or embed (B,
    d)); ``t`` the position (an int).  Returns (logits (B, V) f32, cache),
    the cache updated in place."""
    t = int(t)
    if cfg.frontend == "tokens":
        inp = token_or_embed[:, None]
    else:
        inp = token_or_embed[:, None, :]
    B = inp.shape[0]
    pos_embed = torch.full((B, 1), t, dtype=torch.int32, device=inp.device)
    pos = (torch.full((B, 3, 1), t, dtype=torch.int32, device=inp.device)
           if cfg.rope == "mrope" else pos_embed)
    x = _embed_in(cfg, params, inp, pos_embed)
    for r, slots in enumerate(params["blocks"]):
        for spec, bp, slot_cache in zip(cfg.period, slots, cache):
            layer = {k: v[r] for k, v in slot_cache.items()}
            x = _slot_decode(cfg, spec, bp, layer, x, t, pos)
    x = _apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, 0]), cache
