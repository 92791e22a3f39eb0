"""Fault-tolerant training loop: checkpoint/restart + failure injection.

Port of `src/repro/runtime/trainer.py`.  `Trainer` composes a step
function, a deterministic batch function and the async checkpointer into
the restart-safe loop a training job runs.  `FailureInjector` simulates
host or process crashes at chosen steps, so tests and drivers exercise the
recovery path end to end: crash -> restore the latest checkpoint -> the
batch function resumes at the restored step -> the same trajectory.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry, SpanTracer
from repro_torch.runtime.checkpoint import (AsyncCheckpointer, latest_step,
                                            restore_checkpoint)

Tree = Any

__all__ = ["SimulatedFailure", "FailureInjector", "TrainerConfig", "Trainer"]


class SimulatedFailure(RuntimeError):
    """Stands in for a host crash or preemption in tests and drivers."""


class FailureInjector:
    def __init__(self, fail_at_steps: Iterable[int] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 8


class Trainer:
    """step_fn(state, batch) -> (state, metrics); state is any tree the
    checkpointer flattens (dicts, tuples, NamedTuples of tensors).

    batch_fn(step) -> batch (deterministic in step: the restart contract).
    Restores from the newest checkpoint under ``cfg.ckpt_dir`` if one
    exists.  The returned metrics must be ``float()``-able scalars (0-d
    tensors): converting them waits for the step's device work, so the
    recorded step time covers it, not just the launches.
    """

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 batch_fn: Callable[[int], Tree], init_state: Tree,
                 *, injector: Optional[FailureInjector] = None,
                 log_fn: Callable[[str], None] = print,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state = init_state
        self.injector = injector
        self.log = log_fn
        # step-time histogram + restore/checkpoint counters; shares the
        # driver's registry when one is passed, so train metrics land in
        # the same --metrics-out document
        self.registry = registry if registry is not None else MetricsRegistry()
        # span structure train -> train/step -> train/step/{batch,checkpoint}
        self.trace = tracer if tracer is not None else SpanTracer(self.registry)
        self._h_step = self.registry.histogram(
            "train_step_seconds", desc="batch_fn + step_fn wall time")
        self._c_steps = self.registry.counter(
            "train_steps_total", desc="optimizer steps run")
        self._c_restores = self.registry.counter(
            "train_restores_total", desc="checkpoint restores (restarts)")
        self._c_ckpts = self.registry.counter(
            "train_checkpoints_total", desc="checkpoints written")
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.step = 0
        self.metrics_history: list[dict] = []
        self._maybe_restore()

    def _maybe_restore(self):
        s = latest_step(self.cfg.ckpt_dir)
        if s is not None:
            self.state, _ = restore_checkpoint(self.cfg.ckpt_dir, self.state,
                                               step=s)
            self.step = s
            self._c_restores.inc()
            self.log(f"[trainer] restored checkpoint step={s}")

    def _run_until(self, until_step: int):
        while self.step < until_step:
            if self.injector is not None:
                self.injector.maybe_fail(self.step)
            with self.trace.span("step", step=self.step):
                with self.trace.span("batch"):
                    batch = self.batch_fn(self.step)
                t0 = time.time()
                self.state, metrics = self.step_fn(self.state, batch)
                # float() of a CUDA scalar waits for the step's kernels, so
                # this wall time (and the enclosing span) covers device work
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step_time_s"] = time.time() - t0
            metrics["step"] = self.step
            self._h_step.observe(metrics["step_time_s"])
            self._c_steps.inc()
            self.metrics_history.append(metrics)
            self.step += 1
            if self.step % self.cfg.ckpt_every == 0:
                with self.trace.span("checkpoint", step=self.step):
                    self.ckpt.save(self.step, self.state,
                                   metadata={"step": self.step})
                self._c_ckpts.inc()
            if self.step % self.cfg.log_every == 0:
                keys = [k for k in ("loss", "accuracy", "grad_norm")
                        if k in metrics]
                msg = " ".join(f"{k}={metrics[k]:.4f}" for k in keys)
                self.log(f"[trainer] step={self.step} {msg}")

    def avg_step_time(self, *, skip: int = 1) -> float:
        """Mean step wall time (s) over the recorded history, dropping the
        first ``skip`` steps (first-call costs: kernel library loads,
        allocator warm-up)."""
        ts = [m["step_time_s"] for m in self.metrics_history[skip:]]
        return float(np.mean(ts)) if ts else float("nan")

    def run(self, num_steps: int) -> Tree:
        """Run to ``self.step + num_steps``, surviving injected failures."""
        target = self.step + num_steps
        restarts = 0
        with self.trace.span("train", steps=num_steps):
            while self.step < target:
                try:
                    self._run_until(target)
                except SimulatedFailure as e:
                    restarts += 1
                    if restarts > self.cfg.max_restarts:
                        raise RuntimeError("too many restarts") from e
                    self.log(f"[trainer] {e}; restarting from latest "
                             f"checkpoint")
                    self.ckpt.wait()
                    self._maybe_restore()
            self.ckpt.wait()
        return self.state

    def close(self):
        """Flush checkpoints and shut down a closable batch source."""
        self.ckpt.wait()
        closer = getattr(self.batch_fn, "close", None)
        if callable(closer):
            closer()
