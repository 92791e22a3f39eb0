"""Straggler mitigation policy engine.

Port of `src/repro/runtime/straggler.py`, carried over verbatim: the
policy is numpy over host-side durations, so it needs no device.

On a synchronous SPMD cluster one slow host stalls every step.  The
production mitigations this module encodes:

  * **Detection** — per-host step-duration EMA; a host whose duration
    exceeds `threshold` x the fleet median for `patience` consecutive steps
    is flagged.
  * **Deadline steps** — optional per-step deadline = `deadline_factor` x
    median; a step that would exceed it is *skipped for the straggler's
    shard* (gradient contribution dropped and renormalized — bounded-
    staleness semantics) rather than stalling the fleet.
  * **Eviction / redundancy decision** — a host that stays flagged for
    `evict_after` consecutive steps is proposed for eviction (the elastic
    layer re-meshes without it) or for redundant dispatch (its shard is
    co-scheduled on a healthy host; first result wins).

The engine is deliberately pure-policy (feed durations in, read decisions
out) so it is unit-testable without a cluster and drives both the
failure-injection harness and the simulation benchmark.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["StragglerPolicy", "StragglerMonitor", "HostDecision"]


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    threshold: float = 1.5       # x median => suspicious
    patience: int = 3            # consecutive suspicious steps => straggler
    deadline_factor: float = 2.0 # x median => skip shard this step
    evict_after: int = 3         # flagged windows => propose eviction
    ema: float = 0.3             # duration smoothing


@dataclasses.dataclass
class HostDecision:
    host: int
    straggler: bool
    skip_this_step: bool
    propose_evict: bool
    duration_ema: float
    ratio_to_median: float


class StragglerMonitor:
    def __init__(self, num_hosts: int, policy: StragglerPolicy = StragglerPolicy()):
        self.num_hosts = num_hosts
        self.policy = policy
        self._ema = np.zeros(num_hosts)
        self._initialized = False
        self._suspicious = np.zeros(num_hosts, dtype=int)
        self._flag_windows = np.zeros(num_hosts, dtype=int)
        self.history: List[List[HostDecision]] = []

    def observe(self, durations: Dict[int, float] | np.ndarray) -> List[HostDecision]:
        """Feed one step's per-host durations; get per-host decisions."""
        d = np.asarray([durations[h] for h in range(self.num_hosts)]
                       if isinstance(durations, dict) else durations,
                       dtype=float)
        p = self.policy
        if not self._initialized:
            self._ema = d.copy()
            self._initialized = True
        else:
            self._ema = (1 - p.ema) * self._ema + p.ema * d
        med = float(np.median(self._ema))
        ratios = self._ema / max(med, 1e-12)
        decisions = []
        for h in range(self.num_hosts):
            sus = ratios[h] > p.threshold
            self._suspicious[h] = self._suspicious[h] + 1 if sus else 0
            straggler = self._suspicious[h] >= p.patience
            if straggler:
                self._flag_windows[h] += 1      # persistence counter
            else:
                self._flag_windows[h] = 0
            skip = d[h] > p.deadline_factor * max(float(np.median(d)), 1e-12)
            decisions.append(HostDecision(
                host=h, straggler=bool(straggler),
                skip_this_step=bool(skip),
                propose_evict=bool(self._flag_windows[h] >= p.evict_after),
                duration_ema=float(self._ema[h]),
                ratio_to_median=float(ratios[h]),
            ))
        self.history.append(decisions)
        return decisions

    def effective_step_time(self, durations: np.ndarray,
                            decisions: Optional[List[HostDecision]] = None
                            ) -> float:
        """Fleet step time under the policy: stalled-by-slowest, except hosts
        skipped this step don't gate the barrier."""
        if decisions is None:
            decisions = self.observe(durations)
        alive = [d.host for d in decisions if not d.skip_this_step]
        if not alive:
            return float(np.max(durations))
        return float(np.max(np.asarray(durations)[alive]))

    def gradient_scale(self, decisions: List[HostDecision]) -> float:
        """Renormalization when skipped shards drop out of the global batch."""
        kept = sum(1 for d in decisions if not d.skip_this_step)
        return self.num_hosts / max(kept, 1)
