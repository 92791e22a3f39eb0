"""LM model-level API: parameters, and the train / prefill / decode step
factories the drivers consume.

Port of `src/repro/models/lm.py`: `LMModel` (:38), `TrainStepFns` (:59),
`make_train_step` (:84), `make_prefill_step` (:135),
`decode_cache_specs` (:156) and `make_decode_step` (:184), with the
reference's step signatures, ``step(params, opt_state, batch)``,
``prefill(params, inputs, pos)`` and ``decode(params, cache, tok, t)``.
Prefill and decode run under `torch.no_grad()`, the train step with grad
enabled.  Without a mesh the factories return the step alone (the
reference returns it beside ``None`` shardings).

With a mesh (`repro_torch.launch.mesh.Mesh`) every step runs on the
mesh's ranks (`repro_torch.nn.tensor_parallel` writes the layout out)
and the factories return the step beside the placements, as the
reference's do: `TrainStepFns` with ``in_shardings`` /
``out_shardings`` / ``batch_spec``, ``(prefill, param_shardings)`` and
``(decode, param_shardings, cache_shardings)``.  The sharded train step
takes the parameters and the optimizer state (its moments laid out like
the parameters, its step whole on every rank) as `ShardedTree` handles
or whole trees, and returns handles (``gather`` brings them back) and
the whole batch's metrics.  The parameters and the cache stay
on the ranks between calls: a step takes a
`repro_torch.runtime.elastic.ShardedTree` (from `reshard`), or a whole
tree that it lays out first; it returns the logits whole on the
caller's device (the inputs' device) and the KV / cache as a
`ShardedTree` (`gather` brings it back).  Decode's MoE counts its
capacity over each rank's tokens (the mesh rule); the reference's
decode counts it over the whole batch, which gives the same result
wherever no choice is dropped: at most 8 tokens a rank a step, since a
capacity is at least 8.  ``step.timing = True`` records each rank's
span and its time in collectives in ``step.last_stats``.  A rank's work
in each step is one function of its `AxisGroups`, its slices and the
batch that returns tensors (`rank_train`, `rank_prefill`,
`rank_decode`): the ranks call it, and `repro_torch.launch.dryrun_lib`
traces it on fake tensors.

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
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, set_matmul_precision
from repro_torch.distributed.accumulate import accumulate_gradients
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              batch_axes_for, constrain,
                                              join_batch, named_shardings,
                                              prune_specs_for_mesh,
                                              tree_flatten, tree_map)
from repro_torch.nn.mamba import BACKENDS
from repro_torch.nn.transformer import (LMConfig, lm_decode_step, lm_init,
                                        lm_loss, lm_prefill, param_count)
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     adamw_update_)

__all__ = ["LMModel", "TrainStepFns", "decode_cache_specs",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "lm_params_from_jax", "lm_params_to_jax", "opt_state_specs",
           "prefill_kv_specs", "rank_decode", "rank_prefill", "rank_train",
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


def _batch_specs(cfg: LMConfig, mesh, mask: bool = False) -> dict:
    """`PartitionSpec`s of the training batch dict (the reference's
    `src/repro/models/lm.py:69`): every leaf's rows over (pod, data);
    ``mask`` adds the mask's."""
    if mesh is None:
        return {}
    b = batch_axes_for(mesh)
    specs = {"labels": P(b, None), "pos": P(b, None)}
    if mask:
        specs["mask"] = P(b, None)
    if cfg.rope == "mrope":
        specs["pos"] = P(b, None, None)
    if cfg.frontend == "tokens":
        specs["tokens"] = P(b, None)
    else:
        specs["embeds"] = P(b, None, None)
    return specs


def opt_state_specs(param_specs) -> OptState:
    """The optimizer state's specs: the moments mirror the parameters,
    the step counter is whole on every rank."""
    return OptState(step=P(), m=param_specs, v=param_specs)


def make_train_step(cfg: LMConfig, opt: AdamWConfig, *, mesh=None,
                    n_micro: int = 1, param_specs=None, params_shape=None,
                    donate: bool = True) -> TrainStepFns:
    """The train step: gradients over ``n_micro`` micro-batches (summed
    in float32 when more than one), then AdamW.  ``step(params,
    opt_state, batch)`` returns ``(params, opt_state, metrics)`` with
    ``grad_norm`` and ``lr`` merged into `lm_loss`'s metrics (0-d
    tensors).  ``donate=True`` updates ``params`` and the moments in
    place (the reference donates both buffers); ``donate=False`` returns
    new tensors and leaves the inputs untouched.

    With a mesh, ``param_specs`` (`lm_param_specs`) and ``params_shape``
    are required; the step runs on the mesh's ranks, parameters split
    FSDP / TP by their specs, the moments alike, the batch over (pod,
    data) (micro-batch ``i`` is the global rows ``[i mb, (i+1) mb)``, a
    mask counted over the whole micro-batch); the gradient's norm, the
    clipping and the metrics are the whole batch's.  ``params`` and
    ``opt_state`` may be whole trees or `ShardedTree` handles on the
    mesh (`reshard` by ``step.pspecs`` / ``step.ospecs``); the step
    returns handles: with ``donate=True`` the ones it was given (their
    tensors updated on the ranks), else new ones."""
    cfg = train_config(cfg)
    set_matmul_precision()
    if mesh is not None:
        pspecs = _param_specs(mesh, param_specs, params_shape)
        p_shard = named_shardings(mesh, pspecs)
        o_shard = OptState(step=NamedSharding(mesh, P()), m=p_shard,
                           v=p_shard)
        bspecs = _batch_specs(cfg, mesh)
        b_shard = {k: NamedSharding(mesh, v) for k, v in bspecs.items()}
        return TrainStepFns(
            step=_MeshTrain(cfg, mesh, pspecs, opt, n_micro, donate),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, None), batch_spec=bspecs)
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


def make_prefill_step(cfg: LMConfig, *, mesh=None, param_specs=None,
                      params_shape=None, backend: str = "cuda"):
    """Prefill: (params, inputs, pos) -> (last-token logits, kvs).
    ``inputs`` tokens (B, S) or embeds (B, S, d); ``pos`` (B, S), or (B,
    3, S) for mrope.  With a mesh: ``(prefill, param_shardings)``;
    ``param_specs`` (`lm_param_specs`) and ``params_shape`` (anything
    shaped like the parameters: meta tensors do) are required, and
    ``kvs`` comes back as a `ShardedTree` laid out by
    `decode_cache_specs`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    set_matmul_precision()
    if mesh is not None:
        pspecs = _param_specs(mesh, param_specs, params_shape)
        return (_MeshPrefill(cfg, mesh, pspecs, backend),
                named_shardings(mesh, pspecs))

    @torch.no_grad()
    def prefill(params, inputs, pos):
        return lm_prefill(params, cfg, inputs, pos, backend=backend)

    return prefill


def decode_cache_specs(cfg: LMConfig, mesh, cache_shape, *,
                       model_axis: str = "model"):
    """KV-cache `PartitionSpec`s: batch over (pod, data); kv heads over
    ``model_axis`` when divisible, else the cache sequence over it
    (sequence-sharded KV).  Attention slot leaves: (R, B, S, K, hd);
    Mamba ``h``: (R, B, d_inner, N); Mamba ``conv``: (R, B, d_conv-1,
    d_inner)."""
    b = batch_axes_for(mesh)
    tp = mesh.shape[model_axis] if model_axis in mesh.axis_names else 1

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 5:                      # attention KV (R,B,S,K,hd)
            if cfg.n_kv % tp == 0 and tp > 1:
                return P(None, b, None, model_axis, None)
            if shape[2] % tp == 0 and tp > 1:
                return P(None, b, model_axis, None, None)
            return P(None, b, None, None, None)
        if len(shape) == 4 and cfg.mamba is not None and \
                shape[2] == cfg.mamba.d_conv - 1:  # (R,B,dc-1,di)
            return P(None, b, None, model_axis)
        if len(shape) == 4:                      # mamba h (R,B,di,N)
            return P(None, b, model_axis, None)
        return P(*([None] * len(shape)))

    return tree_map(spec_for, cache_shape)


def make_decode_step(cfg: LMConfig, *, mesh=None, param_specs=None,
                     params_shape=None, cache_shape=None):
    """Decode: (params, cache, token_or_embed, t) -> (logits, cache), the
    cache updated in place; ``t`` the step's position (an int).  Decode
    runs no kernel, so there is no backend to choose.  With a mesh:
    ``(decode, param_shardings, cache_shardings)``; ``cache_shape``
    (anything shaped like `init_lm_cache`'s cache) is required too, and
    the cache stays on the ranks as a `ShardedTree`."""
    set_matmul_precision()
    if mesh is not None:
        if cache_shape is None:
            raise ValueError("make_decode_step(mesh=...) needs cache_shape")
        pspecs = _param_specs(mesh, param_specs, params_shape)
        cspecs = prune_specs_for_mesh(
            mesh, decode_cache_specs(cfg, mesh, cache_shape), cache_shape)
        return (_MeshDecode(cfg, mesh, pspecs, cspecs),
                named_shardings(mesh, pspecs), named_shardings(mesh, cspecs))

    @torch.no_grad()
    def decode(params, cache, tok, t):
        return lm_decode_step(params, cfg, cache, tok, t)

    return decode


# ---------------------------------------------------------------------------
# the mesh paths: the caller's side and the ranks'

def _param_specs(mesh, param_specs, params_shape):
    if param_specs is None or params_shape is None:
        raise ValueError("a mesh step needs param_specs (lm_param_specs) "
                         "and params_shape")
    return prune_specs_for_mesh(mesh, param_specs, params_shape)


def _on_ranks(tree, mesh, specs):
    """``tree`` as a `ShardedTree` on ``mesh``: laid out here unless it is
    one already (on this mesh)."""
    from repro_torch.runtime.elastic import ShardedTree, reshard
    if isinstance(tree, ShardedTree):
        if tree.mesh is not mesh:
            raise ValueError("the tree lies on another mesh; move it with "
                             "runtime.elastic.remesh_state")
        return tree
    return reshard(tree, mesh, specs)


class _RankClock:
    """Inside a rank: the span of a step (CUDA events on the card, the
    host clock on the CPU) and, with ``timing``, its time in
    collectives."""

    def __init__(self, r, timing: bool):
        self.r, self.timing, self.stats = r, timing, {}

    def __enter__(self):
        from repro_torch.distributed.ranks import collective_timing
        if self.timing:
            collective_timing(True)
        self.t0 = time.perf_counter()
        if self.r.device.type == "cuda":
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed.ranks import (collective_ms,
                                                   collective_timing)
        if self.r.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.stats["device_ms"] = self.ev.elapsed_time(end)
        self.stats["wall_ms"] = (time.perf_counter() - self.t0) * 1e3
        if self.timing:
            self.stats["collective_ms"] = collective_ms()
            collective_timing(False)


def rank_prefill(mesh, lp, inputs: torch.Tensor, pos: torch.Tensor, *,
                 cfg: LMConfig, backend: str, kv_specs):
    """The prefill step's work on a rank, tensors in and out: ``mesh`` its
    `AxisGroups`, ``lp`` its `Local` slice of the parameters, ``inputs``
    / ``pos`` the whole batch (the rank takes its rows).  Returns (its
    rows' last-token logits, whole over ``model``; its slices of
    ``kvs`` by ``kv_specs``)."""
    from repro_torch.nn.tensor_parallel import lm_prefill_tp
    bspec = P(batch_axes_for(mesh))
    inputs, pos = constrain(inputs, mesh, bspec), constrain(pos, mesh, bspec)
    with torch.no_grad():
        return lm_prefill_tp(lp, cfg, mesh, inputs, pos, backend=backend,
                             kv_specs=kv_specs)


def rank_decode(mesh, lp, cache, tok: torch.Tensor, t: int, *,
                cfg: LMConfig) -> torch.Tensor:
    """The decode step's work on a rank: ``cache`` its `Local` slice of
    the cache (written in place), ``tok`` the whole batch's tokens.
    Returns its rows' logits, whole over ``model``."""
    from repro_torch.nn.tensor_parallel import lm_decode_tp
    tok = constrain(tok, mesh, P(batch_axes_for(mesh)))
    with torch.no_grad():
        return lm_decode_tp(lp, cfg, mesh, cache, tok, t)


def _r_prefill(r, mesh_key: str, params_key: str, kv_key: str, cfg,
               backend: str, inputs_w, pos_w, kv_specs, timing: bool):
    from repro_torch.distributed.ranks import from_wire, to_wire
    from repro_torch.distributed.sharding import Local
    from repro_torch.nn.tensor_parallel import MODEL
    set_matmul_precision()
    mesh = r.state[mesh_key]
    inputs, pos = from_wire(inputs_w, r.device), from_wire(pos_w, r.device)
    with _RankClock(r, timing) as clock:
        logits, kvs = rank_prefill(mesh, r.state[params_key], inputs, pos,
                                   cfg=cfg, backend=backend,
                                   kv_specs=kv_specs)
    r.state[kv_key] = Local(kvs, kv_specs, mesh)
    return (to_wire(logits) if mesh.index(MODEL) == 0 else None,
            clock.stats)


def _r_decode(r, mesh_key: str, params_key: str, cache_key: str, cfg,
              tok_w, t: int, timing: bool):
    from repro_torch.distributed.ranks import from_wire, to_wire
    from repro_torch.nn.tensor_parallel import MODEL
    set_matmul_precision()
    mesh = r.state[mesh_key]
    tok = from_wire(tok_w, r.device)
    with _RankClock(r, timing) as clock:
        logits = rank_decode(mesh, r.state[params_key], r.state[cache_key],
                             tok, t, cfg=cfg)
    return (to_wire(logits) if mesh.index(MODEL) == 0 else None,
            clock.stats)


class _MeshStep:
    def __init__(self, cfg: LMConfig, mesh, pspecs):
        self.cfg, self.mesh, self.pspecs = cfg, mesh, pspecs
        self.timing = False
        self.last_stats: list = []

    def _logits(self, got: list, batch: int, device) -> torch.Tensor:
        from repro_torch.distributed.ranks import from_wire
        self.last_stats = [g[1] for g in got]
        parts = [None if g[0] is None else from_wire(g[0], device)
                 for g in got]
        return join_batch(self.mesh, batch_axes_for(self.mesh), parts, batch)


def prefill_kv_specs(cfg: LMConfig, mesh, batch: int, seq: int):
    """``(shapes, specs)`` of the mesh prefill's ``kvs``: meta tensors
    (R, B, S, K, hd) per attention slot (None per Mamba slot) and their
    pruned `decode_cache_specs`."""
    kv = torch.empty((cfg.repeats, batch, seq, cfg.n_kv, cfg.head_dim),
                     device="meta")
    shapes = tuple((kv, kv) if spec.kind == "attn" else None
                   for spec in cfg.period)
    return shapes, prune_specs_for_mesh(
        mesh, decode_cache_specs(cfg, mesh, shapes), shapes)


class _MeshPrefill(_MeshStep):
    """The mesh prefill: ``(params, inputs, pos) -> (logits, kvs)``."""

    def __init__(self, cfg, mesh, pspecs, backend):
        super().__init__(cfg, mesh, pspecs)
        self.backend = backend

    def __call__(self, params, inputs, pos):
        from repro_torch.distributed.ranks import to_wire
        from repro_torch.runtime.elastic import ShardedTree
        cfg, mesh = self.cfg, self.mesh
        handle = _on_ranks(params, mesh, self.pspecs)
        B, S = inputs.shape[:2]
        shapes, kv_specs = prefill_kv_specs(cfg, mesh, B, S)
        kv_key = mesh.group.new_key("kv")
        got = mesh.group.run(_r_prefill, None, mesh.key, handle.key, kv_key,
                             cfg, self.backend, to_wire(inputs), to_wire(pos),
                             kv_specs, self.timing)
        leaves, skeleton = tree_flatten(shapes)
        kvs = ShardedTree(mesh=mesh, key=kv_key, skeleton=skeleton,
                          specs=kv_specs,
                          shapes=[tuple(t.shape) for t in leaves],
                          dtypes=[cfg.dtype] * len(leaves))
        return self._logits(got, B, inputs.device), kvs


class _MeshDecode(_MeshStep):
    """The mesh decode: ``(params, cache, tok, t) -> (logits, cache)``."""

    def __init__(self, cfg, mesh, pspecs, cspecs):
        super().__init__(cfg, mesh, pspecs)
        self.cspecs = cspecs

    def __call__(self, params, cache, tok, t):
        from repro_torch.distributed.ranks import to_wire
        handle = _on_ranks(params, self.mesh, self.pspecs)
        cache = _on_ranks(cache, self.mesh, self.cspecs)
        got = self.mesh.group.run(_r_decode, None, self.mesh.key, handle.key,
                                  cache.key, self.cfg, to_wire(tok), int(t),
                                  self.timing)
        return self._logits(got, tok.shape[0], tok.device), cache


def rank_train(mesh, lp, lo, batch: dict, *, cfg: LMConfig,
               opt: AdamWConfig, n_micro: int, bspecs: dict,
               donate: bool = True):
    """The train step's work on a rank, tensors in and out: its slices of
    the gradient (the loss of its rows of each micro-batch, the FSDP
    reduce-scatters in the backward, the sums over the batch axes after),
    the whole gradient's norm, and AdamW on its slices of the parameters
    ``lp`` and moments ``lo`` (`Local`), in place with ``donate``, else
    into new tensors.  ``batch`` is the whole batch.  Returns (new
    parameters, new optimizer state, the whole batch's metrics as 0-d
    tensors)."""
    from repro_torch.distributed.accumulate import \
        accumulate_gradients_on_ranks
    from repro_torch.nn.tensor_parallel import lm_loss_tp
    from repro_torch.optim.adamw import global_norm
    grads, _loss, metrics = accumulate_gradients_on_ranks(
        lambda local, mb, rep: lm_loss_tp(local, cfg, mesh, mb, rep=rep),
        lp, batch, n_micro, bspecs)
    gn = global_norm(grads, specs=lp.specs, mesh=mesh)
    update = adamw_update_ if donate else adamw_update
    new_p, new_o, opt_metrics = update(
        opt, grads, lo.tree, lp.tree, decay=weight_decay_mask(lp.tree),
        norm=gn)
    del grads
    return new_p, new_o, dict(metrics, **opt_metrics)


def _r_train(r, mesh_key: str, params_key: str, opt_key: str, out_keys,
             cfg, opt: AdamWConfig, n_micro: int, batch_w: dict,
             bspecs: dict, timing: bool):
    """`rank_train` on a rank's slices, in place (``out_keys`` None) or
    into new tensors kept under ``out_keys``.  Returns (the whole batch's
    metrics, clock stats)."""
    from repro_torch.distributed.ranks import from_wire
    from repro_torch.distributed.sharding import Local
    set_matmul_precision()
    mesh = r.state[mesh_key]
    lp, lo = r.state[params_key], r.state[opt_key]
    batch = {k: from_wire(v, r.device) for k, v in batch_w.items()}
    with _RankClock(r, timing) as clock:
        new_p, new_o, metrics = rank_train(
            mesh, lp, lo, batch, cfg=cfg, opt=opt, n_micro=n_micro,
            bspecs=bspecs, donate=out_keys is None)
    if out_keys is None:
        lo.tree = new_o
    else:
        r.state[out_keys[0]] = Local(new_p, lp.specs, mesh)
        r.state[out_keys[1]] = Local(new_o, lo.specs, mesh)
    return {k: float(v) for k, v in metrics.items()}, clock.stats


class _MeshTrain(_MeshStep):
    """The mesh train step: ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``."""

    def __init__(self, cfg, mesh, pspecs, opt, n_micro, donate):
        super().__init__(cfg, mesh, pspecs)
        self.ospecs = opt_state_specs(pspecs)
        self.opt, self.n_micro, self.donate = opt, n_micro, donate

    def __call__(self, params, opt_state, batch):
        from repro_torch.distributed.ranks import to_wire
        from repro_torch.runtime.elastic import ShardedTree
        mesh = self.mesh
        rows = {k: v.shape[0] for k, v in batch.items()}
        if len(set(rows.values())) != 1 or \
                next(iter(rows.values())) % self.n_micro:
            raise ValueError(f"batch rows {rows} do not split into "
                             f"{self.n_micro} micro-batches")
        handle = _on_ranks(params, mesh, self.pspecs)
        o_handle = _on_ranks(opt_state, mesh, self.ospecs)
        bspecs = _batch_specs(self.cfg, mesh, mask="mask" in batch)
        out_keys = (None if self.donate else
                    (mesh.group.new_key("tree"), mesh.group.new_key("tree")))
        got = mesh.group.run(_r_train, None, mesh.key, handle.key,
                             o_handle.key, out_keys, self.cfg, self.opt,
                             self.n_micro,
                             {k: to_wire(v) for k, v in batch.items()},
                             bspecs, self.timing)
        self.last_stats = [g[1] for g in got]
        dev = next(iter(batch.values())).device
        metrics = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                   for k, v in got[0][0].items()}
        if out_keys is None:
            return handle, o_handle, metrics
        like = lambda h, key: ShardedTree(  # noqa: E731
            mesh=mesh, key=key, skeleton=h.skeleton, specs=h.specs,
            shapes=h.shapes, dtypes=h.dtypes)
        return (like(handle, out_keys[0]), like(o_handle, out_keys[1]),
                metrics)


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
