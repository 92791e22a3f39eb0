"""Estimating (paper §7.2) — hyper-parameter search.

Port of `src/repro/core/tuner.py` (`SEARCH_SPACE`, `evolve`, `tune`,
`TunerResult`, `community_profile` and the measured stage:
`plan_facing_dim`, `select_variant_measured`, `measured_tune`); the
search and the community graphs are unchanged, the model and the
feasibility bound are the port's (`core/model.py`, priced for
`H100_SXM`), so scores differ from the reference's by design.  The
measured stage races the gather kernels on the card through
`obs.profile.measure`.

Implements the paper's three-step strategy:

  1. *Community profiling*: generate synthetic communities at 90/70/50%
     densities over the typical community sizes observed in the input, and
     evaluate candidate settings on them (here: with the white-box kernel
     model over EXACT tile counts from real partitions of the synthetic
     communities — the offline-profiling analogue).
  2. *Estimation*: score a given (graph, GNN) input with the calibrated
     model without building full schedules.
  3. *Evolutionary optimization*: population → keep elite → crossover +
     mutation, 10–15 iterations (paper: "10-15 iterations … enough").

The search space is the knob set (gs, gpt, dt, src_win) constrained by the
Eq. 3/4 feasibility checks in `core.model` (Eq. 4 = the kernels' own
per-block shared memory).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.extractor import GraphProps, extract_graph_props
from repro_torch.core.model import (AggConfig, KernelModel,
                                    config_infeasibility, paper_eq2_latency)
from repro_torch.core.partition import partition_graph
from repro_torch.graphs.csr import CSRGraph, random_community_graph
from repro_torch.hw import H100_SXM, GPUSpec

__all__ = ["TunerResult", "evolve", "tune", "community_profile",
           "SEARCH_SPACE", "select_variant_measured", "measured_tune", "MEASURED_VARIANTS",
           "plan_facing_dim"]

# gather kernels the measured stage races by default: the folded one-hot
# kernel (the default) vs the gather kernel.  slot_onehot computes what
# folded computes with one more multiply a slot, so it is not raced
# unless a caller asks.
MEASURED_VARIANTS = ("folded", "direct")

SEARCH_SPACE = {
    "gs": [4, 8, 16, 32, 64],
    "gpt": [8, 16, 32, 64, 128],
    "dt": [64, 128, 256, 512],
    "src_win": [128, 256, 512, 1024, 2048],
}


@dataclasses.dataclass
class TunerResult:
    best: AggConfig
    best_score: float
    history: list  # (iteration, best_score)
    evaluations: int  # UNIQUE score-fn evaluations (duplicates are memoized)
    # best-first (score, config) over every UNIQUE config scored — the
    # candidate list the measured stage (`measured_tune`) races on the card
    top: list = dataclasses.field(default_factory=list)
    # (config, variant) -> measured p50 seconds, filled by `measured_tune`
    measured: dict = dataclasses.field(default_factory=dict)


def _random_config(rng: np.random.Generator,
                   base: AggConfig = AggConfig()) -> AggConfig:
    # non-searched fields (ont, variant, feat_dtype) ride along from `base`
    return dataclasses.replace(
        base,
        gs=int(rng.choice(SEARCH_SPACE["gs"])),
        gpt=int(rng.choice(SEARCH_SPACE["gpt"])),
        dt=int(rng.choice(SEARCH_SPACE["dt"])),
        src_win=int(rng.choice(SEARCH_SPACE["src_win"])),
    )


def _crossover(a: AggConfig, b: AggConfig, rng: np.random.Generator) -> AggConfig:
    pick = lambda x, y: x if rng.random() < 0.5 else y
    return dataclasses.replace(
        a, gs=pick(a.gs, b.gs), gpt=pick(a.gpt, b.gpt),
        dt=pick(a.dt, b.dt), src_win=pick(a.src_win, b.src_win))


def _mutate(c: AggConfig, rng: np.random.Generator, p: float = 0.25) -> AggConfig:
    kw = dataclasses.asdict(c)
    for k, space in SEARCH_SPACE.items():
        if rng.random() < p:
            vals = space
            i = vals.index(kw[k]) if kw[k] in vals else len(vals) // 2
            j = int(np.clip(i + rng.integers(-1, 2), 0, len(vals) - 1))
            kw[k] = vals[j]
    return AggConfig(**kw)


def evolve(score_fn: Callable[[AggConfig], float], *, pop: int = 16,
           iters: int = 12, elite: int = 4, seed: int = 0,
           base: AggConfig = AggConfig(),
           infeasibility_fn: Optional[
               Callable[[AggConfig], Optional[str]]] = None,
           max_attempts_per_member: int = 64) -> TunerResult:
    """Generic evolutionary loop (lower score = better).

    Duplicate configs are never re-scored: crossover of a small elite
    re-produces identical `AggConfig`s constantly, and profile-mode score
    functions build REAL partitions per call — a seen-map turns those
    repeats into dict hits.  ``TunerResult.evaluations`` therefore counts
    UNIQUE score-function evaluations (the tuner's true cost).

    ``base`` seeds the non-searched config fields (ont, variant,
    feat_dtype); ``infeasibility_fn`` (reason string or None = feasible)
    overrides the default `config_infeasibility` — e.g. one bound to another
    `GPUSpec`.  Rejection sampling is
    BOUNDED: a sparse-but-nonempty feasible region proceeds with the
    partial population it found; a fully infeasible space raises a
    `RuntimeError` naming the violated constraints instead of spinning
    forever."""
    rng = np.random.default_rng(seed)
    if infeasibility_fn is None:
        infeasibility_fn = config_infeasibility
    feasible_fn = lambda c: infeasibility_fn(c) is None
    population = []
    attempts, reasons = 0, []
    budget = max_attempts_per_member * pop
    while len(population) < pop:
        if attempts >= budget:
            if population:
                # sparse feasible region: run with what we found rather
                # than abort (the elites will breed inside it)
                break
            uniq = list(dict.fromkeys(reasons[-16:]))
            raise RuntimeError(
                f"tuner search space is infeasible: {attempts} rejection-"
                f"sampling attempts produced {len(population)}/{pop} "
                f"feasible configs (feat_dtype={base.feat_dtype}).  "
                f"Sample rejection reasons: {uniq}")
        c = _random_config(rng, base)
        attempts += 1
        reason = infeasibility_fn(c)
        if reason is None:
            population.append(c)
        else:
            reasons.append(reason)
    seen: dict[AggConfig, float] = {}

    def score(c: AggConfig) -> float:
        s = seen.get(c)
        if s is None:
            s = seen[c] = score_fn(c)
        return s

    history = []
    scored = [(score(c), c) for c in population]
    for it in range(iters):
        scored.sort(key=lambda x: x[0])
        history.append((it, scored[0][0]))
        keep = [c for _, c in scored[:elite]]
        children = []
        child_attempts = 0
        # the elites are feasible, so feasible children are normally easy to
        # produce — but a tight feasibility surface can make mutation
        # near-always-reject; bound the attempts and continue with a
        # smaller brood rather than spin
        while (len(children) < pop - elite
               and child_attempts < max_attempts_per_member * pop):
            a, b = rng.choice(len(keep), 2, replace=True)
            child = _mutate(_crossover(keep[a], keep[b], rng), rng)
            child_attempts += 1
            if feasible_fn(child):
                children.append(child)
        scored = scored[:elite] + [(score(c), c) for c in children]
    scored.sort(key=lambda x: x[0])
    history.append((iters, scored[0][0]))
    ranked = sorted(seen.items(), key=lambda kv: kv[1])
    return TunerResult(best=scored[0][1], best_score=scored[0][0],
                       history=history, evaluations=len(seen),
                       top=[(s, c) for c, s in ranked[:8]])


def community_profile(community_sizes: Sequence[int], dim: int, *,
                      densities: Sequence[float] = (0.9, 0.7, 0.5),
                      seed: int = 0) -> Callable[[AggConfig], float]:
    """Step 1: build a profiling score over synthetic communities.

    Returns a score function that evaluates a config by building REAL
    partitions over the synthetic community graphs (the reference's: one
    `random_community_graph` per size and density) and pricing them with
    the white-box model over exact tile counts.
    """
    graphs: list[CSRGraph] = []
    for cs in community_sizes:
        for rho in densities:
            g = random_community_graph(max(4, 2048 // max(cs, 2)), cs,
                                       p_intra=rho, p_inter_edges_per_node=0.2,
                                       seed=seed)
            graphs.append(g)
    props = [extract_graph_props(g, detect_communities=False) for g in graphs]
    km = KernelModel()

    def score(cfg: AggConfig) -> float:
        tot = 0.0
        for g, pr in zip(graphs, props):
            p = partition_graph(g, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                                src_win=cfg.src_win)
            tot += km.latency(pr, dim, cfg, tiles=p.num_tiles)
        return tot / len(graphs)

    return score


def tune(g: CSRGraph, dim: int, *, props: GraphProps | None = None,
         mode: str = "model", iters: int = 12, pop: int = 16,
         seed: int = 0, feat_dtype: str = "float32",
         variant: str = "folded",
         hw: GPUSpec = H100_SXM) -> TunerResult:
    """Pick (gs, gpt, dt, src_win) for a given graph and embedding dim.

    mode="model":   white-box model over predicted tile counts (fast; §7.1).
    mode="profile": score by building real partitions (exact tiles; §7.2).
    mode="paper":   literal Eq. 2 surrogate (fidelity baseline).

    ``feat_dtype`` is the feature/activation dtype policy: every candidate
    is stamped with it, the kernel model prices its ``bytes_feat``, and
    feasibility applies its alignment — the returned ``best`` therefore
    passes `config_infeasibility` (None) under its own dtype.  ``variant`` (port
    addition) names the gather kernel the plan will run; the model and
    Eq. 4 price that kernel.
    """
    pr = props or extract_graph_props(g, detect_communities=False)
    km = KernelModel(hw=hw)
    base = AggConfig(feat_dtype=feat_dtype, variant=variant)
    if mode == "model":
        score = lambda c: km.latency(pr, dim, c)
    elif mode == "profile":
        def score(c: AggConfig) -> float:
            p = partition_graph(g, gs=c.gs, gpt=c.gpt, ont=c.ont, src_win=c.src_win)
            return km.latency(pr, dim, c, tiles=p.num_tiles)
    elif mode == "paper":
        score = lambda c: paper_eq2_latency(pr, dim, c)
    else:
        raise ValueError(mode)
    return evolve(score, pop=pop, iters=iters, seed=seed, base=base,
                  infeasibility_fn=lambda c: config_infeasibility(c, hw=hw))


# ---------------------------------------------------------------------------
# Measured stage — close the loop GNNAdvisor §5 only seeds analytically.
# ---------------------------------------------------------------------------

def plan_facing_dim(plan, default: int = 64) -> int:
    """The feature width the KERNEL actually sees for a plan: after the
    §4.2 dimension-reduced placement the aggregation runs at hidden_dim,
    otherwise at in_dim.  This is the dim the measured selector races at
    and the dim bucket `PlanCache` memoizes variant decisions under."""
    arch = getattr(plan, "arch", None)
    if arch is None:
        return default
    return arch.hidden_dim if plan.reduce_dim_first else arch.in_dim


def _device_features(num_nodes: int, dim: int, seed: int, feat_dtype: str,
                     device):
    """Deterministic (num_nodes, dim) features from
    ``np.random.default_rng(seed)``, moved to ``device`` once."""
    import torch
    feat = np.random.default_rng(seed).standard_normal(
        (num_nodes, dim)).astype(np.float32)
    return torch.as_tensor(feat).to(device=device,
                                    dtype=getattr(torch, feat_dtype))


def _race_p50(m) -> float:
    """The p50 a race compares: device-only where measured, else wall."""
    return m.device_p50 if m.device_samples else m.p50


def select_variant_measured(plan, *, backend: str = "cuda", device="cuda",
                            variants: Sequence[str] = MEASURED_VARIANTS,
                            dim: int | None = None, iters: int = 3,
                            warmup: int | None = 2, seed: int = 0,
                            margin: float = 0.05,
                            registry=None) -> tuple[str, dict]:
    """Race the gather kernels on one PLANNED schedule and pick the winner.

    Runs the plan's forward schedule under each candidate variant through
    `repro_torch.obs.profile.measure` (synchronize-honest, warmup absorbed)
    on deterministic features at the plan's kernel-facing dim, and returns
    ``(best_variant, {variant: p50_seconds})``.  On the card the p50 is
    the device-only one (`Measurement.device_p50`): the host's share of a
    call is the same Python for every variant, so on the wall clock it
    only adds its jitter to a difference the kernels make (off the card,
    the wall p50).

    Candidate ORDER is a preference: a later candidate only unseats an
    earlier one by beating its p50 by more than ``margin`` (relative), so
    measurement noise — including the ``"torch"`` backend, where every
    variant runs the same plain version — resolves to the FIRST candidate
    (the default).  The selector only moves away from the default on a
    strict, beyond-noise win; it never picks a variant measurably slower
    than the default.

    The measurement is per (schedule, dim) — callers memoize it per
    workload shape class (`PlanCache` keys on the fingerprint + pow2 dim
    bucket) rather than per graph.
    """
    from repro_torch.core.aggregate import PlanExecutor
    from repro_torch.device import resolve_device
    from repro_torch.obs.profile import measure

    variants = tuple(variants)
    if not variants:
        raise ValueError("need at least one candidate variant")
    cfg = plan.config
    dev = resolve_device(device)
    d = int(dim) if dim is not None else plan_facing_dim(plan)
    feat = _device_features(plan.graph.num_nodes, d, seed, cfg.feat_dtype,
                            dev)
    sched = plan.sched(dev)
    p50s: dict = {}
    for v in variants:
        ex = PlanExecutor.from_schedule(
            sched, dt=cfg.dt, variant=v, backend=backend, device=dev,
            out_dtype=cfg.feat_dtype)
        p50s[v] = _race_p50(measure(ex, feat, warmup=warmup, iters=iters))
    best = variants[0]
    for v in variants[1:]:
        if p50s[v] < p50s[best] * (1.0 - margin):
            best = v
    if registry is not None:
        for v, p50 in p50s.items():
            registry.gauge(
                "variant_measured_p50_seconds", labels={"variant": str(v)},
                desc="measured p50 of the planned schedule per gather "
                     "variant (select_variant_measured)").set(p50)
        registry.counter(
            "variant_selected_total", labels={"variant": str(best)},
            desc="measured gather-variant selections, by winner").inc()
    return best, p50s


def measured_tune(g: CSRGraph, dim: int, *, top_k: int = 2,
                  variants: Sequence[str] = MEASURED_VARIANTS,
                  backend: str = "cuda", device="cuda", mode: str = "model",
                  iters: int = 12, pop: int = 16, seed: int = 0,
                  feat_dtype: str = "float32", hw: GPUSpec = H100_SXM,
                  measure_iters: int = 3, warmup: int | None = 2,
                  props: GraphProps | None = None) -> TunerResult:
    """Analytical search, then measure the top-k candidates per variant.

    Step 1 is the plain `tune` (the paper's evolutionary search over the
    white-box model); step 2 builds REAL partitions for the ``top_k`` best
    unique configs, races each under every candidate gather variant through
    `repro_torch.obs.profile.measure`, and returns a `TunerResult` whose
    ``best`` is the measured winner (variant stamped into the config) and
    whose ``best_score`` is its measured p50 in seconds.  The full
    measurement table lands in ``TunerResult.measured`` as
    ``{(config, variant): p50}`` (device-only p50s on the card, as in
    `select_variant_measured`).
    """
    from repro_torch.core.aggregate import PlanExecutor
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ops import DeviceSchedule
    from repro_torch.obs.profile import measure

    analytic = tune(g, dim, props=props, mode=mode, iters=iters, pop=pop,
                    seed=seed, feat_dtype=feat_dtype, hw=hw)
    candidates = ([c for _, c in analytic.top[:max(top_k, 1)]]
                  or [analytic.best])
    dev = resolve_device(device)
    feat = _device_features(g.num_nodes, dim, seed, feat_dtype, dev)

    table: dict = {}
    for cfg in candidates:
        p = partition_graph(g, gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                            src_win=cfg.src_win)
        sched = DeviceSchedule(p, dev)
        for v in variants:
            ex = PlanExecutor.from_schedule(
                sched, dt=cfg.dt, variant=v, backend=backend, device=dev,
                out_dtype=feat_dtype)
            table[(cfg, v)] = _race_p50(measure(ex, feat, warmup=warmup,
                                                iters=measure_iters))
        del sched
    (best_cfg, best_variant), best_p50 = min(table.items(),
                                             key=lambda kv: kv[1])
    best = dataclasses.replace(best_cfg, variant=best_variant)
    return TunerResult(best=best, best_score=best_p50,
                       history=analytic.history,
                       evaluations=analytic.evaluations,
                       top=analytic.top, measured=table)
