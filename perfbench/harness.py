"""One run of one cell: find its parts by name, run its traffic driver,
read its metrics, judge its outputs, print the result line.

A cell is an entry of `BENCHMARK.json`'s ``workloads``.  Its parts:
  * the configuration, the file its ``configs`` entry names, and its
    architecture, ``arch/<model.arch>.py`` (weights, reference forward,
    counts of work);
  * the traffic mix, ``mixes/<traffic>.json``, whose ``kind`` names the
    driver ``traffic/<kind>.py`` (``run(ctx) -> Outcome``);
  * the limits that decide ``correct``, ``limits/<workload>.json``;
  * each per-layer metric, ``metrics/<name>.py`` (``read(run)``, None
    when it finds nothing to read), or where there is no such file the
    reader of its base name, the part before the first dot
    (``agg_ms.train`` is read by ``metrics/agg_ms.py``).
Adding a cell, a mix or a metric adds files and entries; no file here
names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
from typing import Callable, Dict, Optional

import torch

from perfbench import check
from perfbench.devtrace import TraceSummary
from perfbench.graph import CACHE_DIR, Graph, load_graph

__all__ = ["BENCH_DIR", "Context", "Outcome", "ROOT", "RunRecord",
           "banned_modules", "cell_context", "driver_of", "load_arch",
           "load_benchmark", "load_module", "main", "reader_of", "run_cell"]

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the JAX reference package and JAX itself, compared by top-level name
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a traffic driver gets: the cell's parts, the run's arguments,
    the graph, and the process's start on the host clock."""
    workload: str
    config: dict
    arch: object                # the module arch/<model.arch>.py
    mix: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    backend: str                # the port's backend: "cuda" on the card
    graph: Graph
    t0: float                   # time.perf_counter() at process start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    """What a traffic driver returns."""
    end_to_end: Dict[str, float]    # by metric name
    attempted: int                  # steps or requests in the window
    numbers: Dict[str, float]       # compared against the cell's limits
    plan_s: float
    peak_bytes: int
    trace: Optional[TraceSummary]


@dataclasses.dataclass
class RunRecord:
    """What a metric reader gets."""
    workload: str
    config: dict
    arch: object
    mix: dict
    graph: Graph
    plan_s: float
    trace: Optional[TraceSummary]


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_arch(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The architecture module ``arch/<name>.py``."""
    return load_module(bench_dir / "arch" / f"{name}.py",
                       f"perfbench_arch_{name}")


def reader_of(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The per-layer metric ``name``'s reader: ``metrics/<name>.py``, or
    that of its base name."""
    d = bench_dir / "metrics"
    path = d / f"{name}.py"
    if not path.exists():
        path = d / f"{name.split('.')[0]}.py"
    return load_module(path, "perfbench_metric_" + path.stem.replace(".", "_"))


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def banned_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def cell_context(bench: dict, workload: str, *, seed: int, seconds: float,
                 trace: bool, t0: float, device="cuda", backend="cuda",
                 num_nodes: Optional[int] = None,
                 cache_dir: Optional[pathlib.Path] = CACHE_DIR,
                 bench_dir: pathlib.Path = BENCH_DIR) -> Context:
    """The cell's parts, found by name under ``bench_dir``, and its graph."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(bench_dir.parent / entry["file"])
    mix = _json(bench_dir / "mixes" / f"{cell['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{workload}.json")
    graph = load_graph(config["graph"], num_nodes=num_nodes,
                       cache_dir=cache_dir)
    arch = load_arch(config["model"]["arch"], bench_dir)
    return Context(workload=workload, config=config, arch=arch, mix=mix,
                   limits=limits, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device(device), backend=backend, graph=graph,
                   t0=t0)


def driver_of(ctx: Context, bench_dir: pathlib.Path = BENCH_DIR):
    kind = ctx.mix["kind"]
    return load_module(bench_dir / "traffic" / f"{kind}.py",
                       f"perfbench_traffic_{kind}")


def run_cell(bench: dict, workload: str, *, seed: int, seconds: float,
             trace: bool, t0: float, device="cuda", backend="cuda",
             num_nodes: Optional[int] = None,
             cache_dir: Optional[pathlib.Path] = CACHE_DIR,
             bench_dir: pathlib.Path = BENCH_DIR,
             log: Callable[[str], None] = lambda s: None) -> dict:
    """Run ``workload`` once and return its result line as a dict.

    ``device``, ``backend``, ``num_nodes``, ``cache_dir`` and
    ``bench_dir`` let a test run the same path on the CPU on a small
    replica, or on parts it added; a benchmark run keeps their
    defaults."""
    ctx = cell_context(bench, workload, seed=seed, seconds=seconds,
                       trace=trace, t0=t0, device=device, backend=backend,
                       num_nodes=num_nodes, cache_dir=cache_dir,
                       bench_dir=bench_dir)
    config, mix, limits, graph = ctx.config, ctx.mix, ctx.limits, ctx.graph
    driver = driver_of(ctx, bench_dir)
    out: Outcome = driver.run(ctx)
    unknown = set(limits) - set(out.numbers)
    if unknown:
        raise RuntimeError(f"limits name numbers the driver does not "
                           f"give: {sorted(unknown)}")
    correct, checks = check.judge(out.numbers, limits)

    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if _applies(m, workload):
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                      "unit": m["unit"]}
    else:
        rec = RunRecord(workload=workload, config=config, arch=ctx.arch,
                        mix=mix, graph=graph, plan_s=out.plan_s,
                        trace=out.trace)
        for m in bench["per_layer"]:
            if not _applies(m, workload):
                continue
            value = reader_of(m["name"], bench_dir).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": correct, "attempted": out.attempted, "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": out.peak_bytes},
    }
    if trace and out.trace is not None:
        result["device"]["busy_s"] = out.trace.busy_s
        result["device"]["window_s"] = out.trace.window_s
        result["breakdown"] = {
            "device_ops": [[k, s] for k, s in out.trace.device_ops()],
            "idle_gaps": [[k, s] for k, s in out.trace.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k in sorted(set(out.numbers) - set(checks)):
        log(f"reading {k} = {out.numbers[k]!r} (not compared)")
    for k, (v, lim) in checks.items():
        ok = not math.isnan(v) and v <= lim
        log(f"check {k} = {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}")
    return result


def main(argv, t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def err(msg):
        print(msg, file=sys.stderr, flush=True)

    bench = load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        err(f"unknown workload {args.workload!r}")
        return 2
    if not torch.cuda.is_available():
        err("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        err(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    checks = []
    result = run_cell(bench, args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), t0=t0,
                      log=checks.append)
    found = banned_modules()
    if found:
        err(f"the run loaded {found}: the benchmark may not import JAX or "
            f"the JAX package")
        return 3
    for line in checks:
        err(line)
    print(json.dumps(result), flush=True)
    return 0
