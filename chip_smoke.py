#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch/`).

    python3 chip_smoke.py            # from the repository root, one H100

Phases, each timed, any failure exits non-zero before the result line:

  1. device — the card's name and power limit (``nvidia-smi``), then the
     build of every CUDA kernel from `src/repro_torch/kernels/csrc/` (one
     ``nvcc`` per source, all started together).
  2. kernels vs plain — schedules from the port's planner on the pubmed
     replica (`random_power_law(19717, 4.5)` with GCN A-hat weights) at
     D in {3, 16, 500}, every variant, plus one schedule with unvisited
     node blocks and pow2-padded tiles; the full reddit replica at D in
     {16, 64} on the gather kernel (the analytic tuner's one-hot schedule
     of full reddit pads to 11.7M tiles, where one call takes 0.2-1.7 s);
     float32 and bfloat16, each against its plain PyTorch version on the
     card.  Tolerance: ``max|k-p| / (1 + A) <= 1e-5`` where
     ``A = sum|ev * feat|`` (the plain version on absolute values): a
     float32 sum taken in another order can differ by rounding that scales
     with the summed magnitudes, which cancellation hides from ``|p|``.
     ``max|k-p|/(1+|p|)`` is reported beside it.  A second witness holds
     both float32 sums against the plain version in float64: on every row
     of ``n`` terms the kernel's error must stay within the summation
     bound ``gamma_n * A`` (``gamma_n = n u / (1 - n u)``, ``u = 2^-24``),
     the bound any order of float32 products and sums meets.
  3. serving — `repro_torch.launch.serve_gnn` at pubmed's widths (500
     input features, 3 classes, 19,717 nodes, avg degree 4.5, Zipf-1.1
     requests, batch window 16, 2 hops): the paper's GCN (2 layers, hidden
     16) in float32 and bfloat16 on the folded kernel, GIN (hidden 64,
     depth cut to 2) on the gather kernel, GAT (hidden 16) on the slot
     kernel.  Each run's launch counts are zeroed just before it and read
     just after: the configured kernel must have launched and the plain
     version never; ``--verify`` must pass (1e-5 float32, 2e-2 bfloat16)
     and a few requests must match the same engine on ``backend="torch"``.
     Then each kernel is timed at the largest schedule its run built.

The line before the last is the ``{"kernels": [...]}`` record (times are
medians of 20 CUDA-event-timed calls after 3 warm-up calls, on warm
caches; ``bound_ms`` counts what the function needs on the run's data:
each real edge's id and value, each group holding an edge, each source row
an edge reads and each row an edge writes, 2 FLOP per edge and column,
against `repro_torch.hw.H100_SXM`); the last line is ``{"ok": true, "device": {...}}``.  Details of every check go to
``chiprun_out/chip_smoke_detail.json`` when that directory exists.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
TOL = 1e-5
U32 = 2.0 ** -24          # unit roundoff of float32
SOURCES = {"group_aggregate_onehot[folded]": (
               "src/repro_torch/kernels/csrc/group_aggregate_onehot.cu",
               "src/repro/kernels/group_aggregate.py:67"),
           "group_aggregate_onehot[slot]": (
               "src/repro_torch/kernels/csrc/group_aggregate_onehot.cu",
               "src/repro/kernels/group_aggregate.py:67"),
           "group_aggregate_gather": (
               "src/repro_torch/kernels/csrc/group_aggregate_gather.cu",
               "src/repro/kernels/group_aggregate.py:117")}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event-timed calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


class KernelCase:
    """One kernel call at one shape: padded inputs exactly as
    `kernels.ops.aggregate` hands them to the wrapper, the plain version's
    call on the same inputs, the library yardstick and the bound."""

    def __init__(self, sched, graph, edge_vals, d, dtype, variant, dt, seed,
                 device="cuda"):
        import torch

        from repro_torch.hw import H100_SXM
        from repro_torch.kernels.ops import _pad_to, dim_tile
        gen = torch.Generator(device=device).manual_seed(seed)
        self.s, self.variant, self.d = sched, variant, d
        feat = torch.randn((sched.num_nodes, d), generator=gen,
                           device=device).to(dtype)
        self.dt = dim_tile(dt, d, dtype)
        d_pad = -(-d // self.dt) * self.dt
        self.feat_p = _pad_to(feat, sched.padded_src_rows, d_pad)
        # the library yardstick: one CSR sparse x dense product (f32)
        n = graph.num_nodes
        vals = (torch.ones(graph.num_edges, device=device) if edge_vals is None
                else torch.as_tensor(edge_vals, device=device))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # "sparse CSR is beta"
            self.csr = torch.sparse_csr_tensor(
                torch.as_tensor(graph.indptr, device=device),
                torch.as_tensor(graph.indices, dtype=torch.int64,
                                device=device),
                vals, size=(n, n), check_invariants=False)
        self.dense = feat.float()
        # the bound counts what the function needs on this data, not the
        # schedule's padding: each edge's id and value, each group holding
        # an edge its output row, each source row an edge reads (in the
        # feature dtype) and each row an edge writes (f32) once
        T, gpt, gs = sched.nbrs.shape
        groups = torch.unique(sched.edge_slot)
        src = sched.nbrs.reshape(T * gpt, gs)[sched.edge_slot, sched.edge_pos]
        dst = (sched.tile_node_block.long()[groups // gpt] * sched.ont
               + sched.local_node.reshape(-1)[groups].long())
        n_src, n_dst = torch.unique(src).numel(), torch.unique(dst).numel()
        edges = sched.num_edges
        nbytes = (n_src * d * feat.element_size() + 8 * edges
                  + 4 * groups.numel() + n_dst * d * 4)
        flops = 2.0 * edges * d
        t_bytes = nbytes / H100_SXM.hbm_bw * 1e3
        t_ops = flops / H100_SXM.peak_flops_f32 * 1e3
        self.bound_ms = max(t_bytes, t_ops)
        self.bound_by = "bytes" if t_bytes >= t_ops else "operations"
        self.shape = {"tiles": T, "live_tiles": sched.live_tiles, "gpt": gpt,
                      "gs": gs, "src_win": sched.src_win,
                      "nodes": sched.num_nodes, "edges": edges,
                      "src_rows": n_src, "out_rows": n_dst, "D": d,
                      "dt": self.dt, "dtype": str(dtype).removeprefix("torch."),
                      "runs": sched.num_runs}

    def kernel(self):
        from repro_torch.kernels.group_aggregate import group_aggregate
        s = self.s
        return group_aggregate(
            self.feat_p, s.nbrs, s.edge_val, s.local_node, s.tile_node_block,
            s.tile_window, s.run_start, gs=s.gs, gpt=s.gpt, ont=s.ont,
            src_win=s.src_win, dt=self.dt, out_rows=s.padded_out_rows,
            variant=self.variant)

    def plain(self):
        from repro_torch.kernels.group_aggregate import group_aggregate_plain
        s = self.s
        return group_aggregate_plain(
            self.feat_p, s.nbrs, s.edge_val, s.local_node, s.tile_node_block,
            ont=s.ont, out_rows=s.padded_out_rows)

    def oracle(self, feat, ev):
        """The schedule's sum in float64 (uncounted: a witness, not the
        plain version)."""
        import torch

        from repro_torch.kernels.ref import group_aggregate_ref
        s = self.s
        return group_aggregate_ref(feat, s.nbrs, ev, s.local_node,
                                   s.tile_node_block, s.ont,
                                   s.padded_out_rows, acc_dtype=torch.float64)

    def library(self):
        import torch
        return torch.sparse.mm(self.csr, self.dense)

    def check(self) -> dict:
        """Kernel vs plain version in float32, and both vs the float64
        witness within the float32 summation bound (see the module doc)."""
        import torch
        s, n, d = self.s, self.s.num_nodes, self.d
        k = self.kernel().double()
        p = self.plain().double()
        feat, ev = self.feat_p.double(), s.edge_val.double()
        exact = self.oracle(feat, ev)
        mag = self.oracle(feat.abs(), ev.abs())
        terms = self.oracle(torch.ones_like(feat[:, :1]), (ev != 0).double())
        visited = torch.repeat_interleave(s.block_visited, s.ont)[:n]
        k, p, exact, mag = (t[:n, :d][visited] for t in (k, p, exact, mag))
        terms = terms[:n][visited]
        check(bool(torch.isfinite(k).all()),
              f"non-finite kernel output {self.shape}")
        limit = terms * U32 / (1.0 - terms * U32) * mag

        def over_bound(x):
            err = (x - exact).abs()
            return float(torch.where(
                limit > 0, err / limit.clamp_min(1e-300),
                torch.where(err > 0, torch.inf, 0.0)).max())

        diff = (k - p).abs()
        rec = dict(self.shape, variant=self.variant,
                   max_abs_err=float(diff.max()),
                   max_err=float((diff / (1.0 + p.abs())).max()),
                   max_err_scaled=float((diff / (1.0 + mag)).max()),
                   err_f64=float(((k - exact).abs()
                                  / (1.0 + exact.abs())).max()),
                   plain_err_f64=float(((p - exact).abs()
                                        / (1.0 + exact.abs())).max()),
                   over_bound=over_bound(k), plain_over_bound=over_bound(p),
                   bound_ms=self.bound_ms, bound_by=self.bound_by)
        return rec

    def run(self) -> dict:
        """Check, then time kernel, plain version and library call."""
        import torch
        rec = self.check()
        torch.cuda.empty_cache()
        rec["ms"] = time_ms(self.kernel)
        rec["plain_ms"] = time_ms(self.plain)
        rec["library_ms"] = time_ms(self.library)
        return rec

    @staticmethod
    def holds(rec: dict, what: str) -> None:
        """Fail unless ``rec`` meets both agreement checks."""
        check(rec["max_err_scaled"] <= TOL,
              f"{what}: kernel vs plain {rec['max_err_scaled']:.3e} > {TOL} "
              f"at {rec}")
        check(rec["over_bound"] <= 1.0,
              f"{what}: kernel vs float64 at {rec['over_bound']:.3f} x the "
              f"float32 summation bound at {rec}")

    @staticmethod
    def summary(rec: dict) -> str:
        return (f"err={rec['max_err']:.2e} scaled={rec['max_err_scaled']:.2e} "
                f"f64: kernel={rec['err_f64']:.2e} "
                f"plain={rec['plain_err_f64']:.2e} "
                f"bound-share={rec['over_bound']:.3f}/"
                f"{rec['plain_over_bound']:.3f} "
                f"ms={rec['ms']:.3f} plain={rec['plain_ms']:.3f} "
                f"lib={rec['library_ms']:.3f} "
                f"bound={rec['bound_ms']:.5f} ({rec['bound_by']})")


def kernel_sweeps(detail: dict) -> list:
    """Phase 2: every variant vs its plain version on planner schedules."""
    import torch

    from repro_torch.core.advisor import plan_for
    from repro_torch.core.partition import pad_partition_tiles
    from repro_torch.graphs.csr import random_power_law
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.graphs.subgraph import pad_to_nodes
    from repro_torch.kernels.group_aggregate import VARIANTS
    from repro_torch.kernels.ops import DeviceSchedule, aggregate
    from repro_torch.models.gnn import gcn_edge_values

    t0 = time.time()
    pubmed, vals_p = gcn_edge_values(random_power_law(19717, 4.5, seed=0))
    reddit_g, _, _ = make_dataset("reddit", max_dim=1)
    reddit, vals_r = gcn_edge_values(reddit_g)
    log(f"graphs: pubmed n={pubmed.num_nodes} e={pubmed.num_edges}, "
        f"reddit n={reddit.num_nodes} e={reddit.num_edges} "
        f"({time.time() - t0:.1f}s)")
    padded = pad_to_nodes(pubmed, 32768)     # edge-less tail: unvisited blocks
    records = []
    cases = [("pubmed", pubmed, vals_p, 16, (3, 16, 500), False, VARIANTS),
             ("pubmed-padded", padded, vals_p, 16, (16,), True, VARIANTS),
             ("reddit", reddit, vals_r, 64, (16, 64), False, ("direct",))]
    for name, g, vals, dim, widths, pad, variants in cases:
        plan = None
        for variant in variants:
            t1 = time.time()
            # one schedule per kernel: the slot variant runs the one-hot
            # kernel on the schedule tuned for folded
            if plan is None or variant == "direct":
                plan = plan_for(g, arch="gcn", in_dim=dim, hidden_dim=dim,
                                edge_vals=vals, tune_iters=4,
                                variant=variant)
            part = plan.partition
            if pad:
                part = pad_partition_tiles(part, 1 << part.num_tiles.bit_length())
                check(not part.block_visited().all(), "padded schedule has no "
                      "unvisited block")
            sched = DeviceSchedule(part, "cuda")
            cfg = plan.config
            log(f"{name} {variant}: gs={cfg.gs} gpt={cfg.gpt} dt={cfg.dt} "
                f"src_win={cfg.src_win} tiles={part.num_tiles} "
                f"runs={sched.num_runs} (plan {time.time() - t1:.1f}s)")
            for d in widths:
                for dtype in (torch.float32, torch.bfloat16):
                    case = KernelCase(sched, g, vals, d, dtype, variant,
                                      cfg.dt, seed=d)
                    rec = dict(case.run(), graph=name)
                    records.append(rec)
                    log(f"  D={d} {rec['dtype']}: {KernelCase.summary(rec)}")
                    KernelCase.holds(rec, f"{name} {variant}")
                    del case
            if pad:
                # the public entry point masks unvisited blocks to zeros
                x = torch.randn((part.num_nodes, 16), device="cuda")
                out = aggregate(x, sched, dt=cfg.dt, backend="cuda",
                                variant=variant)
                rows = torch.repeat_interleave(
                    sched.block_visited, sched.ont)[:part.num_nodes]
                check(bool((out[~rows] == 0).all()) and bool(
                    torch.isfinite(out).all()),
                      f"{variant}: unvisited node blocks are not zero")
            del sched
            torch.cuda.empty_cache()
    detail["sweeps"] = records
    return records


SERVE_COMMON = ["--num-nodes", "19717", "--avg-degree", "4.5",
                "--in-dim", "500", "--classes", "3", "--layers", "2",
                "--hops", "2", "--batch-window", "16", "--zipf", "1.1",
                "--verify", "8", "--device", "cuda", "--backend", "cuda"]
SERVE_PHASES = [
    ("gcn-f32", "folded", 16, ["--arch", "gcn", "--hidden-dim", "16",
                               "--requests", "256"]),
    ("gcn-bf16", "folded", 16, ["--arch", "gcn", "--hidden-dim", "16",
                                "--requests", "256", "--dtype", "bfloat16"]),
    ("gin-f32", "direct", 500, ["--arch", "gin", "--hidden-dim", "64",
                                "--requests", "64"]),
    ("gat-f32", "slot_onehot", 16, ["--arch", "gat", "--hidden-dim", "16",
                                    "--requests", "64"]),
]


def serving(detail: dict) -> dict:
    """Phase 3: the main path, one run per (arch, dtype, variant)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.launch import serve_gnn
    from repro_torch.serving import ServingEngine

    at_serving = {}
    detail["serving"] = []
    for name, variant, width, flags in SERVE_PHASES:
        t0 = time.time()
        kname = ga.KERNEL_OF_VARIANT[variant]
        ga.reset_launches()
        res = serve_gnn.run(SERVE_COMMON + flags + ["--variant", variant])
        counts = dict(ga.launches)
        eng, s = res["engine"], res["summary"]
        log(f"{name}: launches={counts} batches={s['batches']} "
            f"req/s={s['req_per_s']:.1f} p50={s['p50_ms']:.2f}ms "
            f"p99={s['p99_ms']:.2f}ms hit-rate={s['cache']['hit_rate']:.2f}")
        check(res["ok"], f"{name}: serve_gnn verify/cache check failed "
              f"(verify err {res['verify_err']})")
        check(counts[kname] > 0, f"{name}: {kname} never launched")
        check(counts[ga.PLAIN] == 0, f"{name}: plain version ran "
              f"{counts[ga.PLAIN]} times on the main path")
        for other, c in counts.items():
            if other not in (kname, ga.PLAIN):
                check(c == 0, f"{name}: unconfigured kernel {other} launched")
        # a few requests against the same engine on the plain versions
        tol = 1e-5 if eng.cfg.feat_dtype == "float32" else 2e-2
        plain = ServingEngine(eng.graph, eng.feat,
                              dataclasses.replace(eng.cfg, backend="torch"),
                              params=eng.params, serving=eng.serving)
        done = [r for r in res["requests"] if r.status == "done"][:4]
        err = 0.0
        for r in done:
            ref = plain.serve_batch([r.seed])[0]
            check(np.isfinite(r.result).all() and r.result.shape == (3,),
                  f"{name}: bad result {r.result}")
            err = max(err, float((np.abs(r.result - ref)
                                  / (1.0 + np.abs(ref))).max()))
        check(err <= tol, f"{name}: kernel engine vs torch engine {err:.2e} > {tol}")
        # the kernel at the largest schedule this run built
        ent = max(eng.cache._plans.values(),
                  key=lambda e: e.plan.partition.num_tiles)
        case = KernelCase(ent.executor.sched, ent.plan.graph,
                          ent.plan.partition.edge_values_csr(), width,
                          eng.cfg.compute_dtype, variant, ent.plan.config.dt,
                          seed=7)
        rec = case.run()
        KernelCase.holds(rec, f"{name}: {kname} at the serving shape")
        # every fired batch, the --verify re-serves included (the counts
        # include their launches too)
        served = int(eng.stats.batches.value)
        rec.update(phase=name, launches=counts[kname], batches_served=served,
                   launches_per_batch=counts[kname] / max(served, 1),
                   req_per_s=s["req_per_s"], p50_ms=s["p50_ms"],
                   p99_ms=s["p99_ms"], verify_err=res["verify_err"],
                   torch_engine_err=err, seconds=time.time() - t0)
        detail["serving"].append(rec)
        at_serving.setdefault(kname, rec)      # the float32 run comes first
        log(f"{name}: verify={res['verify_err']:.2e} torch-engine={err:.2e} "
            f"kernel at {rec['tiles']} tiles ({rec['live_tiles']} live, "
            f"{rec['edges']} edges) D={rec['D']}: {KernelCase.summary(rec)} "
            f"({time.time() - t0:.1f}s)")
        del plain, res, eng
        torch.cuda.empty_cache()
    return at_serving


def main() -> int:
    t_start = time.time()
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False: this smoke test needs "
            "the card")
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels", "csrc")):
        log(f"FAIL: {SRC}/repro_torch not found: run from a checkout of the "
            f"repository")
        return 2
    sys.path.insert(0, SRC)
    detail: dict = {}
    try:
        t0 = time.time()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
        print(card, flush=True)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        from repro_torch.kernels import build
        reports = build.build_all()
        ptxas = {k: [l.strip() for l in v.splitlines() if "Used" in l]
                 for k, v in reports.items()}
        log(f"phase device: built {sorted(reports)} in {time.time() - t0:.1f}s")
        detail.update(card=card, ptxas=ptxas)

        t0 = time.time()
        sweeps = kernel_sweeps(detail)
        log(f"phase kernels: {len(sweeps)} checks in {time.time() - t0:.1f}s")

        t0 = time.time()
        at_serving = serving(detail)
        log(f"phase serving: {time.time() - t0:.1f}s")
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1

    from repro_torch.kernels.group_aggregate import KERNEL_OF_VARIANT
    kernels = []
    for variant, kname in KERNEL_OF_VARIANT.items():
        rec = at_serving[kname]
        checks = [r for r in sweeps if r["variant"] == variant] + [rec]
        source, replaces = SOURCES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": rec["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in checks),
            "max_err": max(r["max_err"] for r in checks),
            "max_err_scaled": max(r["max_err_scaled"] for r in checks),
            "err_f64": max(r["err_f64"] for r in checks),
            "plain_err_f64": max(r["plain_err_f64"] for r in checks),
            "over_bound": max(r["over_bound"] for r in checks),
            "plain_over_bound": max(r["plain_over_bound"] for r in checks),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "phase": rec["phase"],
            "shape": {k: rec[k] for k in ("tiles", "live_tiles", "gpt", "gs",
                                          "src_win", "nodes", "edges", "D",
                                          "dt", "dtype")},
            "launches_per_batch": rec["launches_per_batch"],
            "batches_served": rec["batches_served"]})
    detail["kernels"] = kernels
    out_dir = os.path.join(ROOT, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "chip_smoke_detail.json"), "w") as f:
            json.dump(detail, f, indent=1)
    log(f"total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
