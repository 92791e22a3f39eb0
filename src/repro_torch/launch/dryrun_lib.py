"""One dry-run cell: (architecture x input shape x mesh), priced for one
rank without the hardware.

Port of `src/repro/launch/dryrun_lib.py`: `abstract_params_and_specs`
(:39), `active_param_fraction` (:58), `model_flops` (:81),
`cell_filename` (:95) and `run_cell` (:99).  The reference lowers and
compiles the step under a mesh of placeholder devices and reads the
compiled module.  The port runs the step's rank program itself, on fake
tensors (`torch._subclasses.fake_tensor.FakeTensorMode`: shapes and
dtypes, no memory; on ``cuda`` where a card is visible) in a fake
process group of the mesh's size
(`torch.testing._internal.distributed.fake_pg`: collectives return at
once), as one rank of that mesh:

  * the rank's `AxisGroups` and its slices of the parameters, the AdamW
    moments, the cache and the batch, by the specs the mesh steps use
    (`lm_param_specs` pruned for the mesh, `opt_state_specs`,
    `decode_cache_specs`, the batch over (pod, data)); every rank's
    slices have the same shapes when every split divides its dim, which
    `valid_spec` guarantees, and the traced rank is the one with the
    most bytes otherwise;
  * the step body the ranks run (`repro_torch.models.lm.rank_train`,
    `rank_prefill`, `rank_decode`), traced under
    `repro_torch.launch.cost.CostCounter`: FLOPs, bytes, collective
    bytes by kind and by mesh axis, and the peak of live storages.  A
    mesh of one rank is one card: its cell traces the one-device step
    (`make_train_step` / `make_prefill_step` / `make_decode_step`
    without a mesh), which is what one card runs (the rank program's
    vocab-parallel loss holds more than the one-device chunked one);
  * the report: the reference's keys, with ``trace_s`` in place of
    ``lower_s`` / ``compile_s`` and no ``hlo_bytes``, plus ``fits``
    (under ``memory``), ``useful_flops_ratio`` and the mesh axes whose
    groups span more than one node (``node_crossing_axes``).

Arguments of the step (the rank's parameters, moments, whole batch and
cache slices) are counted apart from the step's own peak; the batch is
counted whole, as a rank receives it.  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import SHAPES, cell_is_runnable, get_arch
from repro_torch.distributed.sharding import (prune_specs_for_mesh,
                                              shard_index, tree_leaves,
                                              tree_map)
from repro_torch.hw import H100_SXM
from repro_torch.launch.cost import (CostCounter, alloc_bytes,
                                     memory_summary, roofline_terms)
from repro_torch.nn.transformer import LMConfig, lm_init, lm_param_specs

__all__ = ["MESH_AXES", "abstract_params_and_specs", "active_param_fraction",
           "cell_filename", "model_flops", "run_cell"]

# the fake tensors' device: the card's where one is visible, else the CPU
# (without a card PyTorch cannot index a tensor that claims one: its
# device guard sets the device); fake tensors on either take the same
# paths (the scan's wrapper and `mamba_forward` treat any fake tensor as
# a card tensor)
_DEV = "cuda" if torch.cuda.is_available() else "cpu"

# axes of a mesh by its rank, as `launch/mesh.py:make_production_mesh`
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def abstract_params_and_specs(cfg: LMConfig):
    """(parameters on ``meta``, their `PartitionSpec`s) without
    allocating."""
    return lm_init(cfg, None, device="meta"), lm_param_specs(cfg)


def _tree_size(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def active_param_fraction(cfg: LMConfig, params) -> dict:
    """Total vs MoE-active matmul parameters (embedding gather excluded
    from the 'active' figure; the unembed logits matmul included), by the
    reference's arithmetic over the port's per-layer blocks."""
    total = _tree_size(params)
    embed = _tree_size(params["embed"]) if "embed" in params else 0
    active = 0
    for slots in params["blocks"]:
        for slot_p in slots:
            slot_total = _tree_size(slot_p)
            if (cfg.moe is not None and "ffn" in slot_p
                    and "router" in slot_p["ffn"]):
                expert = _tree_size({k: v for k, v in slot_p["ffn"].items()
                                     if k in ("wi", "wo")})
                slot_total -= expert
                slot_total += expert * cfg.moe.topk // cfg.moe.n_experts
                slot_total += _tree_size(slot_p["ffn"]["router"])
            active += slot_total
    if "unembed" in params:
        active += _tree_size(params["unembed"])
    elif cfg.tie_embeddings and embed:
        active += embed                 # tied table used as the logits matmul
    return {"total": total, "active_matmul": active, "embed": embed}


def model_flops(cfg: LMConfig, params, shape_name: str,
                shape=None) -> float:
    """6 N_active tokens for training, 2 N_active tokens for inference
    (decode: one token a sequence)."""
    shape = shape or SHAPES[shape_name]
    n_active = active_param_fraction(cfg, params)["active_matmul"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def cell_filename(arch: str, shape: str, mesh_name: str) -> str:
    return f"{arch}__{shape}__{mesh_name}.json"


# ---------------------------------------------------------------------------
# one rank's slices


class _Grid:
    """The mesh as `shard_index` reads it (axis names and sizes)."""

    def __init__(self, shape: tuple, axes: tuple):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, shape))

    def coords(self, rank: int) -> dict:
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            rank, tuple(self.shape.values())))))


def _local_shape(grid: _Grid, spec, shape: tuple, coords: dict) -> tuple:
    return tuple(len(range(n)[s]) for n, s in
                 zip(shape, shard_index(grid, spec, shape, coords)))


def _traced_rank(grid: _Grid, specs, shapes) -> int:
    """Rank 0 when every split divides its dim (every rank's slices have
    rank 0's shapes), else the rank whose slices hold the most bytes."""
    pairs = list(zip(tree_leaves(specs), tree_leaves(shapes)))
    even = all(
        x.shape[d] % int(np.prod([grid.shape[a] for a in
                                  ((e,) if isinstance(e, str) else e)])) == 0
        for sp, x in pairs for d, e in enumerate(sp) if e is not None)
    if even:
        return 0
    n = int(np.prod(list(grid.shape.values())))
    sizes = [sum(int(np.prod(_local_shape(grid, sp, tuple(x.shape),
                                          grid.coords(r))))
                 * x.element_size() for sp, x in pairs) for r in range(n)]
    return int(np.argmax(sizes))


def _slices(grid: _Grid, specs, shapes, coords: dict, new, dtype=None):
    """This rank's slices of the ``meta`` tree ``shapes`` under ``specs``,
    each made by ``new(shape, dtype)``."""
    return tree_map(lambda x, sp: new(
        _local_shape(grid, sp, tuple(x.shape), coords), dtype or x.dtype),
        shapes, specs)


def _storage_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees``, each rounded as
    the allocator rounds it."""
    seen: dict = {}                 # id -> storage (kept alive: ids unique)
    for t in tree_leaves(list(trees)):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen.setdefault(id(st), st)
    return sum(alloc_bytes(st.nbytes()) for st in seen.values())


def _batch(cfg: LMConfig, B: int, S: int, new) -> dict:
    """The whole training batch as the reference's `input_specs` shapes
    it (int32 ids and positions, bf16 embeds)."""
    i32 = torch.int32
    b = {"labels": new((B, S), i32),
         "pos": new((B, 3, S) if cfg.rope == "mrope" else (B, S), i32)}
    if cfg.frontend == "tokens":
        b["tokens"] = new((B, S), i32)
    else:
        b["embeds"] = new((B, S, cfg.d_model), torch.bfloat16)
    return b


def _node_crossing(grid: _Grid, rank: int, axes: tuple,
                   node_cards: int) -> bool:
    """Whether this rank's group along ``axes`` spans more than one node
    (rank ``r`` on node ``r // node_cards``)."""
    n = int(np.prod(list(grid.shape.values())))
    me = grid.coords(rank)
    members = [r for r in range(n) if all(
        c == me[a] for a, c in grid.coords(r).items() if a not in axes)]
    return len({r // node_cards for r in members}) > 1


def _trace(kind: str, cfg: LMConfig, shape, grid: _Grid, n_micro: int,
           params_meta, specs, real: Optional[str],
           transport: str) -> dict:
    """Bring up the fake process group, build the traced rank's slices
    and trace its step; returns its figures: FLOPs, bytes, peak and
    argument bytes, the collectives' ``by_kind`` / ``counts`` /
    ``by_axis``, the per-op table ``ops``, the traced ``rank`` and which
    axis groups cross nodes (``crossing``).  ``real`` (a device) runs the
    same step on real zero-filled tensors there instead of fake ones,
    only on a mesh of one rank (the fake group moves no data)."""
    import contextlib

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.device import set_matmul_precision
    from repro_torch.distributed.ranks import AxisGroups
    from repro_torch.distributed.sharding import Local
    from repro_torch.models.lm import (_batch_specs, decode_cache_specs,
                                       make_decode_step, make_prefill_step,
                                       make_train_step, opt_state_specs,
                                       prefill_kv_specs, rank_decode,
                                       rank_prefill, rank_train, train_config)
    from repro_torch.nn.transformer import init_lm_cache
    from repro_torch.optim.adamw import AdamWConfig, OptState

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("run_cell brings up its own fake process group; "
                           "a default process group already exists")
    world = int(np.prod(list(grid.shape.values())))
    if real is not None and world != 1:
        raise ValueError("a real run needs a mesh of one rank")
    B, S = shape.global_batch, shape.seq_len
    rank = _traced_rank(grid, prune_specs_for_mesh(grid, specs, params_meta),
                        params_meta)
    dev = real or _DEV
    if real is None:
        new = lambda shp, dt: torch.empty(shp, dtype=dt, device=dev)  # noqa
        mode = FakeTensorMode(allow_non_fake_inputs=True)
    else:
        new = lambda shp, dt: torch.zeros(shp, dtype=dt, device=dev)  # noqa
        mode = contextlib.nullcontext()
    set_matmul_precision()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        mesh = AxisGroups(tuple(grid.shape.values()), grid.axis_names, rank)
        pspecs = prune_specs_for_mesh(mesh, specs, params_meta)
        coords = mesh.coords
        with mode:
            lp = Local(_slices(grid, pspecs, params_meta, coords, new),
                       pspecs, mesh)
            if kind == "train":
                cfg = train_config(cfg)
                lo = Local(OptState(
                    step=new((), torch.int32),
                    m=_slices(grid, pspecs, params_meta, coords, new,
                              torch.float32),
                    v=_slices(grid, pspecs, params_meta, coords, new,
                              torch.float32)),
                    opt_state_specs(pspecs), mesh)
                batch = _batch(cfg, B, S, new)
                args = (lp.tree, lo.tree, batch)
                if world == 1:
                    step = make_train_step(cfg, AdamWConfig(),
                                           n_micro=n_micro).step
                    body = lambda: step(lp.tree, lo.tree, batch)  # noqa: E731
                else:
                    body = lambda: rank_train(  # noqa: E731
                        mesh, lp, lo, batch, cfg=cfg, opt=AdamWConfig(),
                        n_micro=n_micro, bspecs=_batch_specs(cfg, mesh))
            elif kind == "prefill":
                whole = _batch(cfg, B, S, new)
                inputs = whole.get("tokens", whole.get("embeds"))
                pos = whole["pos"]
                args = (lp.tree, inputs, pos)
                if world == 1:
                    step = make_prefill_step(cfg, backend="cuda")
                    body = lambda: step(lp.tree, inputs, pos)  # noqa: E731
                else:
                    _, kv_specs = prefill_kv_specs(cfg, mesh, B, S)
                    body = lambda: rank_prefill(  # noqa: E731
                        mesh, lp, inputs, pos, cfg=cfg, backend="cuda",
                        kv_specs=kv_specs)
            else:
                cache_meta = init_lm_cache(cfg, B, max_seq=S, device="meta")
                cspecs = prune_specs_for_mesh(
                    mesh, decode_cache_specs(cfg, mesh, cache_meta),
                    cache_meta)
                lc = Local(_slices(grid, cspecs, cache_meta, coords, new),
                           cspecs, mesh)
                tok = (new((B,), torch.int32) if cfg.frontend == "tokens"
                       else new((B, cfg.d_model), torch.bfloat16))
                args = (lp.tree, lc.tree, tok)
                if world == 1:
                    step = make_decode_step(cfg)
                    body = lambda: step(lp.tree, lc.tree, tok, S - 1)  # noqa
                else:
                    body = lambda: rank_decode(  # noqa: E731
                        mesh, lp, lc, tok, S - 1, cfg=cfg)
            arg_bytes = _storage_bytes(*args)
            with CostCounter() as cc, warnings.catch_warnings():
                # the collectives `ranks.py` calls are named as every
                # supported PyTorch names them; newer ones warn of a rename
                warnings.filterwarnings("ignore", ".*is deprecated. Please "
                                        "use", FutureWarning)
                out = body()
                del out
        # each axis group's bytes; the whole world's group is None
        groups = {g: axes for axes, g in mesh._groups.items()
                  if g is not None}
        by_axis: dict = {}
        for g, n in cc.collective_by_group.items():
            key = ",".join(groups.get(g, grid.axis_names))
            by_axis[key] = by_axis.get(key, 0) + n
        crossing = {",".join(axes): _node_crossing(grid, rank, axes,
                                                   H100_SXM.node_cards)
                    for axes in list(mesh._groups) + [tuple(grid.axis_names)]}
        return {"flops": cc.flops, "product_flops": cc.product_flops,
                "bytes_accessed": cc.bytes_accessed,
                "peak_bytes": (cc.gloo_peak_bytes if transport == "gloo"
                               else cc.peak_bytes),
                "argument_bytes": arg_bytes,
                "by_kind": cc.collectives["by_kind"],
                "counts": cc.collectives["counts"], "by_axis": by_axis,
                "ops": {k: [v.calls, v.flops, v.bytes]
                        for k, v in cc.ops.items()},
                "rank": rank, "crossing": crossing}
    finally:
        dist.destroy_process_group()


def run_cell(arch_name: str, shape_name: str, mesh_shape: tuple,
             mesh_name: str, *, n_micro: int = 1,
             out_dir: Optional[str] = None, use_reduced: bool = False,
             shape_override=None, config_overrides: Optional[dict] = None,
             verbose: bool = True, save_ops: bool = False,
             real: Optional[str] = None, transport: str = "nccl") -> dict:
    """Trace one (arch x shape x mesh) cell on one rank; return the
    report (written to ``out_dir`` when given; ``save_ops`` also writes
    the per-op table beside it).  ``mesh_shape`` is the mesh's sizes,
    over `MESH_AXES` by its rank.  ``use_reduced`` /
    ``shape_override`` / ``config_overrides`` exist for the tests and
    the smoke; production cells use the full config and `SHAPES`.
    ``real`` (a device) runs the step on real zero-filled tensors there
    instead, on a one-rank mesh: the check that the fake trace counts
    what a real step does.  ``transport`` is the ranks' collective
    backend: "nccl" (production), or "gloo" (every rank on one card),
    whose reduce-scatters stage their operand on the card
    (`repro_torch.launch.cost.GLOO_STAGING`, in the peak)."""
    if transport not in ("nccl", "gloo"):
        raise ValueError(f"transport must be nccl or gloo, got {transport!r}")
    arch = get_arch(arch_name)
    shape = shape_override or SHAPES[shape_name]
    mesh_shape = tuple(int(n) for n in mesh_shape)
    axes = MESH_AXES[len(mesh_shape)]
    grid = _Grid(mesh_shape, axes)
    ok, why = cell_is_runnable(arch, shape_name)
    report = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": dict(grid.shape),
        "num_chips": int(np.prod(mesh_shape)),
        "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    }
    if not ok:
        report["skipped"] = why
        if out_dir:
            _save(out_dir, report)
        return report

    cfg = arch.reduced() if use_reduced else arch.full()
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    t0 = time.time()
    params_meta, specs = abstract_params_and_specs(cfg)
    report["params"] = active_param_fraction(cfg, params_meta)
    report["model_flops"] = model_flops(cfg, params_meta, shape_name, shape)
    figs = _trace(shape.kind, cfg, shape, grid, n_micro, params_meta, specs,
                  real, transport)
    report["trace_s"] = time.time() - t0
    report["rank"] = figs["rank"]
    report["n_micro"] = n_micro
    report["memory"] = dict(memory_summary(figs["argument_bytes"],
                                           figs["peak_bytes"]),
                            transport=transport)
    report["cost"] = {k: figs[k] for k in ("flops", "product_flops",
                                           "bytes_accessed")}
    report["collectives"] = {
        "by_kind": figs["by_kind"], "counts": figs["counts"],
        "total_bytes": sum(figs["by_kind"].values()),
        "by_axis": {k: n for k, n in figs["by_axis"].items() if n}}
    report["node_crossing_axes"] = [a for a in axes
                                    if figs["crossing"].get(a)]
    # the collective term: each axis group's bytes over its own link
    t_link = sum(n / (H100_SXM.link_bw_inter if figs["crossing"][k]
                      else H100_SXM.link_bw_intra)
                 for k, n in figs["by_axis"].items())
    total = report["collectives"]["total_bytes"]
    flops = report["cost"]["flops"]
    report["roofline"] = roofline_terms(
        flops=flops, bytes_accessed=report["cost"]["bytes_accessed"],
        collective_total_bytes=total, num_chips=1,
        bf16=cfg.dtype != torch.float32,
        link_bw=(total / t_link) if t_link else None)
    per_chip_model = report["model_flops"] / report["num_chips"]
    report["useful_flops_ratio"] = (per_chip_model / flops) if flops else None
    if out_dir:
        _save(out_dir, report)
        if save_ops:
            table = sorted(({"op": k, "calls": c, "flops": fl, "bytes": b}
                            for k, (c, fl, b) in figs["ops"].items()),
                           key=lambda r: (-r["flops"], -r["bytes"]))
            with open(os.path.join(out_dir, cell_filename(
                    arch_name, shape_name, mesh_name).replace(
                        ".json", ".ops.json")), "w") as f:
                json.dump(table, f, indent=1)
    if verbose:
        r, m = report["roofline"], report["memory"]
        print(f"[dryrun] {arch_name} x {shape_name} x {mesh_name}: "
              f"trace={report['trace_s']:.1f}s "
              f"rank GB={m['total_bytes'] / 1e9:.2f} fits={m['fits']} "
              f"compute={r['t_compute_s']:.4f}s "
              f"memory={r['t_memory_s']:.4f}s "
              f"collective={r['t_collective_s']:.4f}s "
              f"dominant={r['dominant']}", flush=True)
    return report


def _save(out_dir: str, report: dict):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_filename(
        report["arch"], report["shape"], report["mesh"]))
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
