"""The Advisor — ties the whole §4-§7 loop together (paper Fig. 1/Fig. 7).

Port of `src/repro/core/advisor.py`:

  input extractor -> performance evaluator (model+tuner) -> kernel & runtime
  crafter (renumbering + partition + kernel dispatch).

`advise()` is the one-call entry point; `plan_for()` is pure planning (the
serving plan cache's path).  Both return a `repro_torch.core.plan.Plan`;
with ``with_backward=True`` it also carries the transposed graph's
partition, the backward schedule training differentiates through.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.extractor import (GraphProps, extract_arch_props,
                                        extract_graph_props)
from repro_torch.core.model import (AggConfig, config_infeasibility,
                                    feat_dtype_align)
from repro_torch.core.partition import (partition_graph, partition_stats,
                                        transpose_graph)
from repro_torch.core.plan import Plan
from repro_torch.core.reorder import renumber
from repro_torch.core.tuner import tune
from repro_torch.graphs.csr import CSRGraph

__all__ = ["Plan", "advise", "plan_for"]


def advise(g: CSRGraph, *, arch: str = "gcn", in_dim: int = 128,
           hidden_dim: int = 128, num_layers: int = 2,
           edge_vals: Optional[np.ndarray] = None,
           reorder: str = "auto",        # "auto" | "on" | "off"
           tune_mode: str = "model", tune_iters: int = 12,
           config: Optional[AggConfig] = None, seed: int = 0,
           with_backward: bool = False,
           feat_dtype: Optional[str] = None,
           variant: Optional[str] = None) -> Plan:
    """Run the full GNNAdvisor decision loop for one input (``variant``
    as for `plan_for`).

    reorder="auto" applies §6.1 renumbering unless the input already shows
    strong numbering locality or irregular community structure (the
    reference's rule, unchanged).
    """
    props = extract_graph_props(g)

    do_reorder = {"on": True, "off": False}.get(reorder)
    if do_reorder is None:
        already_local = props.numbering_spread < 0.02
        irregular = (props.community_size_stddev
                     > 1.5 * max(props.community_size_mean, 1.0))
        do_reorder = not already_local and not irregular
    perm = None
    g_run = g
    vals_run = edge_vals
    if do_reorder:
        perm = renumber(g, seed=seed)
        g_run = g.permute(perm)
        if edge_vals is not None:
            vals_run = g.permute_edge_vals(perm, edge_vals)
        props = extract_graph_props(g_run, detect_communities=False)

    plan = plan_for(g_run, arch=arch, in_dim=in_dim, hidden_dim=hidden_dim,
                    num_layers=num_layers, edge_vals=vals_run, config=config,
                    tune_mode=tune_mode, tune_iters=tune_iters, seed=seed,
                    props=props, with_backward=with_backward,
                    feat_dtype=feat_dtype, variant=variant)
    plan.perm = perm
    return plan


def plan_for(g: CSRGraph, *, arch: str = "gcn", in_dim: int = 128,
             hidden_dim: int = 128, num_layers: int = 2,
             edge_vals: Optional[np.ndarray] = None,
             config: Optional[AggConfig] = None,
             tune_mode: str = "model", tune_iters: int = 12,
             seed: int = 0, props: Optional[GraphProps] = None,
             with_backward: bool = False,
             feat_dtype: Optional[str] = None,
             variant: Optional[str] = None) -> Plan:
    """Pure planning: props -> (tune unless `config` given) -> partition.

    Never renumbers or mutates the input.

    g : the graph to plan, in its final node numbering.
    arch : "gcn" | "gin" | "gat" — decides the §4.2 aggregation placement.
    edge_vals : optional (E,) float32 aligned with ``g.indices``.
    config : optional AggConfig — skip the tuner, partition with exactly
        these knobs (ValueError when `config_infeasibility` rejects them).
    with_backward : also partition the TRANSPOSED graph under the same
        config and attach it as ``plan.partition_bwd`` (+ ``edge_perm_bwd``),
        so `PlanExecutor` differentiates through the CUDA kernels.  Off by
        default: inference-only plans skip the extra partitioning.
    feat_dtype : optional dtype policy stamped onto the config.
    variant : optional gather kernel stamped onto the config (port
        addition: the reference's measured pick is
        `core.tuner.select_variant_measured`, which a caller runs on the
        plan); None keeps the given config's, or "folded".
    """
    if props is None:
        props = extract_graph_props(g, detect_communities=False)
    archp = extract_arch_props(arch, in_dim, hidden_dim, num_layers)
    tuner_res = None
    if config is None:
        tuner_res = tune(g, archp.hidden_dim if archp.reduce_dim_first
                         else archp.in_dim,
                         props=props, mode=tune_mode, iters=tune_iters,
                         seed=seed, feat_dtype=feat_dtype or "float32",
                         variant=variant or "folded")
        config = tuner_res.best
    else:
        if feat_dtype is not None and config.feat_dtype != feat_dtype:
            config = dataclasses.replace(config, feat_dtype=feat_dtype)
        if variant is not None and config.variant != variant:
            config = dataclasses.replace(config, variant=variant)
        align = feat_dtype_align(config.feat_dtype)
        if config.dt % align:
            raise ValueError(
                f"config dt={config.dt} is not a multiple of the "
                f"{config.feat_dtype} alignment unit {align} — retune "
                f"with feat_dtype={config.feat_dtype!r} or pick an "
                f"aligned dt")
        reason = config_infeasibility(config)
        if reason is not None:
            raise ValueError(f"pinned config {config} is infeasible: "
                             f"{reason}")
    part = partition_graph(g, gs=config.gs, gpt=config.gpt, ont=config.ont,
                           src_win=config.src_win, edge_vals=edge_vals)
    part_bwd = edge_perm = None
    if with_backward:
        gT, vals_t, edge_perm = transpose_graph(g, edge_vals)
        part_bwd = partition_graph(gT, gs=config.gs, gpt=config.gpt,
                                   ont=config.ont, src_win=config.src_win,
                                   edge_vals=vals_t)
    return Plan(
        graph=g, partition=part, config=config, graph_props=props,
        arch=archp, perm=None, tuner=tuner_res, stats=partition_stats(part),
        reduce_dim_first=archp.reduce_dim_first,
        partition_bwd=part_bwd, edge_perm_bwd=edge_perm,
    )
