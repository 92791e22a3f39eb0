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
     node blocks and pow2-padded tiles; the community graph
     `random_community_graph(600, 32)` (7-9 live slots a tile) at D in
     {16, 64} and pinned corners of the tuner's search space on cora
     (`CORNERS`: gs 64, gpt 128, ...) on both one-hot kernels; the full
     reddit replica at D in {16, 64} on the gather kernel (phase 8 times
     both kernels there); float32
     and bfloat16, each against its plain PyTorch version on the card, and
     each call (every variant) run twice, which must give bit-identical
     output.
     Tolerance: ``max|k-p| / (1 + A) <= 1e-5`` where
     ``A = sum|ev * feat|`` (the plain version on absolute values): a
     float32 sum taken in another order can differ by rounding that scales
     with the summed magnitudes, which cancellation hides from ``|p|``.
     ``max|k-p|/(1+|p|)`` is reported beside it.  A second witness holds
     both float32 sums against the plain version in float64: on every row
     of ``n`` terms the kernel's error must stay within the summation
     bound ``gamma_n * A`` (``gamma_n = n u / (1 - n u)``, ``u = 2^-24``),
     the bound any order of float32 products and sums meets.
     2b (``hub``): on the pubmed folded schedule at D 16, the one-hot
     kernel's device time over all runs, over the longest run alone and
     over every other run (`hub_probe`).
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
     3b (``async``): `serve_gnn`'s async tier at the gcn-f32 widths
     (folded kernel, 3 tenants: gold / silver / bronze over ``--slo-ms
     250``, 512 requests) offered half the synchronous gcn-f32 run's
     req/s of the same call (a short synchronous run measures it when
     phase 3 did not run): once with ``--policy deadline``, once with
     ``--policy clock``, then deadline with ``--stream-deltas 4``
     (`ASYNC_RUNS`).  Launch counts zeroed before each run and read after
     its engine closed: the folded kernel launched, nothing else.
     Accounting exact (``submitted == completed + rejected``, nothing
     outstanding) with zero rejections (their reasons are printed);
     ``--verify`` at 1e-5; four requests against a fresh engine on
     ``backend="torch"`` within 1e-5; with deltas every update applied
     with no error, the engine's graph and features equal to the four
     deltas applied here, and the last chunk's requests against a fresh
     engine on that mutated graph within 1e-5.  Per-tenant p50, p99,
     SLO attainment and mean batch are printed.

  4. edge-gradient kernel vs plain — the GAT schedules of the pubmed
     replica (`make_dataset("pubmed")`, 19,717 nodes) from
     ``plan_for(arch="gat", with_backward=True)`` (`EDGE_GRAD_SCHEDULES`):
     one tuned for ``slot_onehot``, one for ``direct`` and a pinned
     ``direct`` config at gs 128; the block edge-gradient kernel, which
     every variant runs, at D in {1, 16, 128}, float32 and bfloat16, real
     slots only, each call run twice (its real slots bit-identical).
     Tolerance: ``max|k-p| / (1 + sum|g*f|) <= 1e-5`` and the float64
     witness within ``gamma_D * sum|g*f|`` on every slot, as phase 2.  Then
     the autograd `Function` on the card: ``feat`` and ``edge_values``
     gradients on ``backend="cuda"`` against ``backend="torch"``, ``<=
     1e-5`` in the same magnitude-scaled form.
  5. training — `repro_torch.launch.train.run` on the full pubmed replica
     (19,717 nodes, in-dim 128, 3 classes, 20 steps each, a fresh
     checkpoint directory per run): GAT hidden 16 on ``slot_onehot`` and
     on ``direct`` (float32), GCN hidden 16 on ``folded`` in float32 and
     bfloat16.  Launch counts are zeroed just before each run and read
     just after: every training step must launch the configured forward
     kernel and, for GAT, the configured edge-gradient kernel exactly as
     often as the model asks (GCN 4 forward-kernel launches per step; GAT
     6 forward and 4 edge-gradient launches: the denominator's all-ones
     input takes no gradient, so its transposed aggregation is skipped);
     the plain versions run only for the label teacher's one forward
     (``planted_labels`` runs on ``backend="torch"`` by design) and never
     in training.  The last loss must be below the first, and three steps
     on ``backend="cuda"`` must match three on ``backend="torch"`` from the
     same parameters within ``max|a-b|/(1+|b|) <= 1e-4``.  The
     edge-gradient kernels are then timed at the GAT runs' hidden-width
     shape (on each GAT run's schedule), and the gather kernel on the GAT
     ``direct`` run's schedule at the input width (128) and at the widths a
     step aggregates (16, 1).
     5b (``sampled``): `repro_torch.launch.train.run` with ``--sampled`` on
     the full reddit replica (232,965 nodes, in-dim 128, 41 classes;
     generated once for the three jobs), ``--fanouts 10,5 --batch-nodes
     512``, 20 steps, the folded kernel, a fresh checkpoint directory per
     job: GCN 2x16 in float32 and bfloat16, GIN hidden 64 (depth cut to
     2) in float32 (`SAMPLED_JOBS`).  Launch counts zeroed just before
     each run and read just after: the folded kernel exactly 4 times a
     GCN step (2 forward, 2 transposed) and 3 a GIN step (block 0's raw
     features take no gradient), the plain version never.  The mean loss
     of the last five steps must be below the first five's, with a
     nonzero gradient norm at each of them (GCN at lr 1e-2, GIN at 1e-3,
     where its ReLUs stay alive).  These two say only that training moves
     and the network lives; the path's correctness checks are the next
     two: three steps on ``backend="cuda"`` and three on ``"torch"`` from
     the same parameters on the same three batches within
     ``max|a-b|/(1+|b|) <= 1e-4``, and the kernel at the block shapes.  On the run's largest batch (by block 0's edges) each block's
     rows past its dst nodes must come back as exact zeros, and every
     schedule a step launches the kernel over (forward at the width it
     aggregates; transposed where the step takes that gradient) is
     checked and timed as in phase 2.  The loader's sample p50, prefetch
     stall p99, plan-cache hit rate, bucket count, step times and block
     sizes are logged and written to the detail JSON.  A fourth job, GCN
     float32 with ``--stream-deltas 5`` for 8 steps, swaps an
     interaction-stream delta into the loader's graph before step 5: it
     must be applied, every consumed batch must carry the graph epoch of
     its step, and its cuda vs torch steps, largest batch and block
     checks are taken on the three steps after the swap.
     5c (``dynamic``): one interaction-stream delta (1% of the nodes'
     worth of edges, the reference's dynamic-benchmark size) through
     ``Plan.apply_delta`` on phase 2's gather plan of the full reddit
     replica and on a train-ready folded GCN plan of the pubmed replica
     (A-hat values from the mutated degrees): the patched path must run;
     the kernel on each patched schedule (forward; transposed for pubmed)
     is held against the plain version and the float64 witness as in
     phase 2 and against the kernel on a fresh ``partition_graph`` of the
     mutated graph at the same config (``/(1 + sum|ev*x|) <= 1e-5``), and
     the autograd Function's feature gradient on the patched pubmed pair
     against ``backend="torch"``.  The host time of ``apply_delta`` is
     printed beside a fresh ``plan_for`` and a same-config repartition.

  6. scan kernel vs plain — `kernels/selective_scan.py` at (B, S, d_inner,
     N) = (2, 64, 128, 8) (the reduced config), (3, 40, 20, 4) (ragged),
     (1, 256, 8192, 16) and (4, 2048, 8192, 16) (one full-width
     Falcon-Mamba layer of the phase-7 prefill), inputs as
     `tests/test_selective_scan.py:_inputs` from a seed.  Kernel vs the
     float32 plain version and vs the float64 witness, each
     ``max|k-p| / (1 + max|p|) <= 1e-5``; times (per call and on the
     device alone) beside the bound (bytes and FLOP terms) and the exp/log
     count over the special-function rate, this design's floor (see
     `scan_bound`); the plain version timed over 3 calls at full width.
     ``--scan-variants NAME,...`` adds the named probe instantiations
     of the kernel (`kProbes` in selective_scan.cu), each held to the
     same limits and timed on the device, and read through 7b and 7c.
  7. LM serving — Falcon-Mamba-7B (`repro_torch.configs.falcon_mamba_7b.full()`,
     64 layers, bf16, random weights from a seeded generator): (a)
     ``make_prefill_step(backend="cuda")`` at B 4, S 2048, 1 warm-up + 5
     timed prefills (host clock, synchronized), exactly 64
     ``selective_scan`` launches per prefill and no plain call or other
     kernel, finite logits, peak memory, one prefill and one decode step
     under `torch.profiler`; (b) cuda vs torch at B 4, S 256: inside one
     cuda-backend prefill every layer's scan operands also go through the
     plain version and the float64 witness, and the float32 scan outputs
     must agree within ``max|a-b|/(1+max|b|) <= 1e-5``; the free-running
     last-token logits of both backends are read beside a control
     without the kernel (fused plain vs chunked path; see `lm_serving`);
     (c) float32 at 4 layers, weight seeds 1-5: prefill (kernel) vs 64
     ``lm_decode_step`` calls (recurrence) within 1e-4 at every seed, the
     plain version's prefill and a prefill in TF32 read beside it; (d)
     ``repro_torch.launch.serve --arch falcon-mamba-7b --full --batch 4
     --prompt-len 16 --gen-len 32`` and its tok/s.
  8. profile — the profiling tier and the measured tuner on the kernels;
     launch counts zeroed just before each part and read just after it,
     the plain version never launched:
     (A) `obs.profile_plan` on the pubmed replica's train-ready GCN plan
     (D 16, float32 and bfloat16, folded: a forward and a transposed row)
     and on phase 2's full-reddit gather plan (D 64, float32; built here
     when phase 2 did not run): p50 / p90 / device p50, model latency,
     residual, achieved bytes/s and edges/s, tiles; the attribution error
     within 0.5, each forward row's device p50 within 1.5x of `time_ms`
     (device only) on the same executor, and the kernel launched exactly
     as often as `measure`'s calls; (B) `select_variant_measured` on the
     smallest and the largest of a gcn-f32 serving run's ego plans at D 16
     and D 500: each candidate's kernel launched, the winner checked
     against the plain version and the float64 witness as in phase 2;
     (C) `measured_tune` (top_k 2) on the pubmed replica at D 500 and on
     full reddit at D 64, the whole ``{(config, variant): p50}`` table
     with each partition's exact tiles beside `predict_tiles`; (D)
     `serve_gnn` at the gcn-f32 widths through a shared
     `PlanCache(measure_variants=True)`: at least one selection and one
     memo hit, the served batches launching only the winners' kernels,
     ``--verify`` and four requests against ``backend="torch"`` at 1e-5;
     (E) ``--trace-out`` of a synchronous and an async (3 tenants,
     deadline) `serve_gnn` run and of a 5-step GCN `train` run: each file
     parses, holds the drivers' ``compute`` / ``train`` spans and a
     ``thread_name`` event per thread (two threads for the async run).
     The profiling registry must pass the exposition lint.
  9. lm-hybrid — the attention + MoE LM stack.  Jamba-v0.1 at full width,
     one period (`jamba_v0_1_52b.full()` cut to 8 layers: 7 Mamba slots,
     one GQA attention slot, 4 MoE and 4 GLU FFNs; 13,295,235,072
     parameters, bf16, seeded random weights): (a)
     ``make_prefill_step(backend="cuda")`` at B 4, S 2048, 1 warm-up + 5
     timed prefills (host clock, synchronized), exactly 7
     ``selective_scan`` launches a prefill and no plain call or other
     kernel, finite logits, the attention slot's ``kvs`` (1, 4, 2048, 8,
     128), peak memory, each MoE layer's dropped share (warm-up run), one
     prefill and one decode step under `torch.profiler`; (b) cuda vs torch
     at B 4, S 256: every Mamba layer's scan operands also through the
     plain version and the float64 witness, ``<= 1e-5``, the free-running
     logits read beside; (c) float32 with the capacity factor at
     n_experts / topk (no token drops in prefill or decode), weight seeds
     1-3, B 2: each layer alone, its prefill forward vs 64 decode steps
     from step 0 on the same input, within 1e-4 (the whole model's
     last-token logits, kernel and plain, read beside: the random
     fan-in-2 FFNs amplify float32 rounding through the period to about
     1e-4); (d) ``repro_torch.launch.serve --arch gemma2-2b --full --batch
     4 --prompt-len 16 --gen-len 32`` (26 layers, bf16) and its tok/s,
     then gemma2-2b in float32 at full width and depth with the local
     layers' window cut to 16 (the ring wraps): prefill at B 2, S 64 vs
     64 decode steps within 1e-4, each layer alone read beside.
  10. lm-train — LM training (`models.lm.make_train_step`: the chunked
     cross-entropy, flash attention's backward, remat, micro-batches,
     AdamW in place): (a) ``repro_torch.launch.train --arch
     h2o-danube-1.8b --full --global-batch 8 --n-micro 2 --seq-len 4096
     --warmup 1 --steps 6 --ckpt-every 1000`` (24 layers, 1,831,201,280
     parameters, bf16, remat "full"): finite losses, the last below the
     first, no kernel launch and no plain call (the path holds no Mamba
     slot), then step ms (mean of steps 2-6), tok/s, the model-FLOP share
     of the bf16 dense peak ((6 N + 12 L H hd S) T a step), peak memory
     and one more step under `torch.profiler` (top device ops, idle
     share); (b) flash attention's backward against plain autograd
     through ``causal_mode="masked_full"`` at h2o's shape (B 1, S 4096,
     32 heads, hd 80, window 4096) and gemma2's local layer (S 8192, hd
     256, softcap 50, window 4096: the banded forward), float32, out / dq
     / dk / dv within 1e-4; (c) the chunked cross-entropy against the
     dense one (B 2, S 2048; V 32,000, and V 256,000 with softcap 30; z
     loss 1e-4): loss, dx, dW within 1e-5, the chunked forward + backward
     peak extra memory below half the dense one's; (d) Falcon-Mamba at
     full width, depth cut to 2 layers (d_inner 8192), B 1, S 1024,
     through ``make_train_step``: the chunked path, so no scan launch and
     no plain call, a finite nonzero gradient norm, and a direct
     ``selective_scan`` call on card tensors that require a gradient
     raises; (e) jamba's reduced config, one float32 step on the card
     against the same step on the CPU: loss, gradient norm, moments and
     new parameters within 1e-4 (a parameter whose gradient is within
     1e-4 of zero may part by 2 lr: Adam's first step is sign(g) lr).


``--phases`` runs a subset of phases 2-10 (names in `PHASES`); with no
arguments every phase runs.  The line before the last is the
``{"kernels": [...]}`` record (times are
medians of 20 CUDA-event-timed calls after 3 warm-up calls, on warm
caches; ``ms`` holds the wrapper's host work, ``device_ms`` the device's
alone (`time_ms`); ``bound_ms`` counts what the function needs on the
run's data: each real edge's id and value, each group holding an edge,
each source row an edge reads and each row an edge writes, 2 FLOP per
edge and column,
against `repro_torch.hw.H100_SXM`; for the edge-gradient kernel (one
record per TPU body it replaces, each on its body's schedule) each real
edge's id and result, each group holding an edge, the source and
cotangent rows edges read, 2 FLOP per edge and column; ``library_ms`` is
one `torch.sparse.mm` for the aggregation kernels and one
`torch.sparse.sampled_addmm` on the same CSR pattern for the
edge-gradient kernels, float32; the folded kernel's record adds
``launches_sampled``, its launches in phase 5b, and its error maxima
cover phase 5b's block-shape checks, and ``launches_async`` its launches
in phase 3b; the gather and folded records' error maxima cover phase
5c's patched schedules, and ``launches_profile`` counts each aggregation
kernel's launches in phase 8; the scan kernel's record is at the
timed shape, its ``launches`` those of phase 7a's six prefills,
``launches_hybrid`` those of phase 9a's six,
``sfu_ms`` the exp/log term beside ``bound_ms``, and ``library_ms``
null: no one PyTorch call computes a selective scan); the last line is
``{"ok": true, "device": {...}}``.  Details of every check go to
``chiprun_out/chip_smoke_detail.json`` when that directory exists.
"""
from __future__ import annotations

import argparse
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
SLEEP_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz boost clock
SLEEP_MS = SLEEP_CYCLES / 1.98e6  # the spin's least length, at that clock
U32 = 2.0 ** -24          # unit roundoff of float32
SOURCES = {"group_aggregate_onehot[folded]": (
               "src/repro_torch/kernels/csrc/group_aggregate_onehot.cu",
               "src/repro/kernels/group_aggregate.py:67"),
           "group_aggregate_onehot[slot]": (
               "src/repro_torch/kernels/csrc/group_aggregate_onehot.cu",
               "src/repro/kernels/group_aggregate.py:67"),
           "group_aggregate_gather": (
               "src/repro_torch/kernels/csrc/group_aggregate_gather.cu",
               "src/repro/kernels/group_aggregate.py:117"),
           "group_edge_grad[block]": (
               "src/repro_torch/kernels/csrc/group_edge_grad.cu",
               "src/repro/kernels/group_aggregate.py:183"),
           "group_edge_grad[block:direct]": (
               "src/repro_torch/kernels/csrc/group_edge_grad.cu",
               "src/repro/kernels/group_aggregate.py:224"),
           "selective_scan": (
               "src/repro_torch/kernels/csrc/selective_scan.cu",
               "src/repro/kernels/selective_scan.py:36")}


# the `kernels` line holds one record per TPU body: the block kernel
# replaces both edge-gradient bodies, so it has a record on the schedule
# of each (`_edge_grad_kernel` for slot_onehot, `_direct_edge_grad_kernel`
# for direct); both count their launches under the kernel's one counter
EDGE_GRAD_RECORDS = {"slot_onehot": "group_edge_grad[block]",
                     "direct": "group_edge_grad[block:direct]"}


class SmokeFailure(Exception):
    pass


# what one phase builds and a later one reuses: phase 2's full reddit
# replica and its gather plan (the dynamic phase patches that plan)
SHARED: dict = {}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3,
            device_only: bool = False) -> float:
    """Median of ``iters`` CUDA-event-timed calls after ``warmup`` calls.

    By default the time between the events holds the host's work inside
    the call (the wrapper's checks, the launch).  ``device_only`` first
    enqueues a spin of about 1 ms (``torch.cuda._sleep``), so the call is
    queued before the start event runs: the time is the device's alone.
    That holds while the host's work in a call stays inside the spin, so
    the median host time of the calls must stay under half of it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        h0 = time.perf_counter()
        s.record()
        fn()
        host.append(1e3 * (time.perf_counter() - h0))
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    if device_only:
        check(statistics.median(host) < SLEEP_MS / 2,
              f"host work of {statistics.median(host):.3f} ms a call does "
              f"not fit in half the {SLEEP_MS:.3f} ms spin: the device-only "
              f"time would hold device idle time")
    return statistics.median(times)


def real_work(sched) -> tuple:
    """What a schedule's function needs on its data, not its padding:
    ``(edges, groups holding an edge, distinct source rows edges read,
    distinct rows edges write)``."""
    import torch
    T, gpt, gs = sched.nbrs.shape
    groups = torch.unique(sched.edge_slot)
    src = sched.nbrs.reshape(T * gpt, gs)[sched.edge_slot, sched.edge_pos]
    dst = (sched.tile_node_block.long()[groups // gpt] * sched.ont
           + sched.local_node.reshape(-1)[groups].long())
    return (sched.num_edges, groups.numel(), torch.unique(src).numel(),
            torch.unique(dst).numel())


def bound(nbytes: float, flops: float) -> tuple:
    """``(bound_ms, bound_by)``: the larger of bytes over the card's
    memory rate and float32 operations over its peak rate."""
    from repro_torch.hw import H100_SXM
    t_bytes = nbytes / H100_SXM.hbm_bw * 1e3
    t_ops = flops / H100_SXM.peak_flops_f32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class KernelCase:
    """One kernel call at one shape: padded inputs exactly as
    `kernels.ops.aggregate` hands them to the wrapper, the plain version's
    call on the same inputs, the library yardstick and the bound."""

    def __init__(self, sched, graph, edge_vals, d, dtype, variant, dt, seed,
                 device="cuda"):
        import torch

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
        edges, groups, n_src, n_dst = real_work(sched)
        self.bound_ms, self.bound_by = bound(
            n_src * d * feat.element_size() + 8 * edges + 4 * groups
            + n_dst * d * 4, 2.0 * edges * d)
        T, gpt, gs = sched.nbrs.shape
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
            variant=self.variant, run_order=s.run_order)

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
        k = self.kernel()
        visited = torch.repeat_interleave(s.block_visited, s.ont)[:n]
        # no atomics and a fixed summation order: bit-identical reruns
        # (rows of unvisited blocks are never written)
        check(torch.equal(k[:n][visited], self.kernel()[:n][visited]),
              f"{self.variant}: two calls differ at {self.shape}")
        k = k.double()
        p = self.plain().double()
        feat, ev = self.feat_p.double(), s.edge_val.double()
        exact = self.oracle(feat, ev)
        mag = self.oracle(feat.abs(), ev.abs())
        terms = self.oracle(torch.ones_like(feat[:, :1]), (ev != 0).double())
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
        """Check, then time kernel, plain version and library call (the
        yardstick only: a library call this PyTorch build lacks is
        reported as None, not a failure)."""
        import torch
        rec = self.check()
        torch.cuda.empty_cache()
        rec["ms"] = time_ms(self.kernel)
        rec["device_ms"] = time_ms(self.kernel, device_only=True)
        rec["plain_ms"] = time_ms(self.plain)
        try:
            rec["library_ms"] = time_ms(self.library)
            rec["library_device_ms"] = time_ms(self.library,
                                               device_only=True)
        except RuntimeError as e:
            log(f"  library call unavailable: {e}")
            rec["library_ms"] = rec["library_device_ms"] = None
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
                f"ms={rec['ms']:.4f} (device {rec['device_ms']:.4f}) "
                f"plain={rec['plain_ms']:.3f} lib={_lib(rec)} "
                f"bound={rec['bound_ms']:.5f} ({rec['bound_by']})")


def kernel_sweeps(detail: dict) -> list:
    """Phase 2: every variant vs its plain version on planner schedules."""
    import torch

    from repro_torch.core.advisor import plan_for
    from repro_torch.core.model import AggConfig
    from repro_torch.core.partition import pad_partition_tiles
    from repro_torch.graphs.csr import random_community_graph, random_power_law
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.graphs.subgraph import pad_to_nodes
    from repro_torch.kernels.group_aggregate import VARIANTS
    from repro_torch.kernels.ops import DeviceSchedule, aggregate
    from repro_torch.models.gnn import gcn_edge_values

    t0 = time.time()
    pubmed, vals_p = gcn_edge_values(random_power_law(19717, 4.5, seed=0))
    community, vals_c = gcn_edge_values(random_community_graph(600, 32,
                                                               seed=0))
    cora, vals_k = gcn_edge_values(make_dataset("cora", max_dim=1)[0])
    reddit_g, _, _ = make_dataset("reddit", max_dim=1)
    reddit, vals_r = gcn_edge_values(reddit_g)
    SHARED["reddit"] = (reddit_g, reddit, vals_r)
    log(f"graphs: pubmed n={pubmed.num_nodes} e={pubmed.num_edges}, "
        f"community n={community.num_nodes} e={community.num_edges}, "
        f"cora n={cora.num_nodes} e={cora.num_edges}, "
        f"reddit n={reddit.num_nodes} e={reddit.num_edges} "
        f"({time.time() - t0:.1f}s)")
    padded = pad_to_nodes(pubmed, 32768)     # edge-less tail: unvisited blocks
    onehot = ("folded", "slot_onehot")
    records = []
    # (name, graph, edge values, planning width, widths, pow2-pad tiles,
    #  variants, pinned config, slot shares the folded schedule)
    cases = [("pubmed", pubmed, vals_p, 16, (3, 16, 500), False, VARIANTS,
              None, True),
             ("pubmed-padded", padded, vals_p, 16, (16,), True, VARIANTS,
              None, True),
             # 7-9 live slots per tile; 11-22% of tiles touch >= 16 rows
             ("community", community, vals_c, 16, (16, 64), False, onehot,
              None, False)]
    # corners of the tuner's search space, pinned (cora: the pubmed
    # replica's padded schedules pass 1 GB there)
    for (gs, gpt, dt, win), d in CORNERS:
        cases.append((f"cora-{gs}x{gpt}", cora, vals_k, d, (d,), False,
                      onehot, AggConfig(gs=gs, gpt=gpt, dt=dt, src_win=win),
                      True))
    cases.append(("reddit", reddit, vals_r, 64, (16, 64), False, ("direct",),
                  None, True))
    for name, g, vals, dim, widths, pad, variants, config, share in cases:
        plan = None
        for variant in variants:
            t1 = time.time()
            # one schedule per kernel: unless ``share`` is off, the slot
            # variant runs the one-hot kernel on folded's schedule
            if plan is None or variant == "direct" or not share:
                plan = plan_for(g, arch="gcn", in_dim=dim, hidden_dim=dim,
                                edge_vals=vals, tune_iters=4,
                                variant=variant, config=config)
                if name == "reddit":
                    SHARED["reddit_plan"] = plan
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


# pinned search-space corners on cora: ((gs, gpt, dt, src_win), D)
CORNERS = [((64, 8, 64, 2048), 16), ((4, 128, 512, 128), 500),
           ((32, 64, 128, 512), 64), ((64, 128, 256, 1024), 130)]


def hub_probe(detail: dict) -> dict:
    """Phase 2b: does the longest run set the one-hot kernel's time?  On
    phase 2's pubmed folded schedule at D 16, float32: device time of the
    kernel over all runs, over the longest (hub) run alone, and over every
    other run (one launch on a copy of the schedule without the hub's
    tiles)."""
    import torch

    from repro_torch.core.advisor import plan_for
    from repro_torch.graphs.csr import random_power_law
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.kernels.ops import DeviceSchedule
    from repro_torch.models.gnn import gcn_edge_values

    g, vals = gcn_edge_values(random_power_law(19717, 4.5, seed=0))
    plan = plan_for(g, arch="gcn", in_dim=16, hidden_dim=16, edge_vals=vals,
                    tune_iters=4, variant="folded")
    case = KernelCase(DeviceSchedule(plan.partition, "cuda"), g, vals, 16,
                      torch.float32, "folded", plan.config.dt, seed=16)
    KernelCase.holds(case.check(), "hub probe")
    s = case.s
    rs = s.run_start
    lens = rs[1:] - rs[:-1]
    h = int(torch.argmax(lens))
    t0, t1 = int(rs[h]), int(rs[h + 1])
    arrays = [s.nbrs, s.edge_val, s.local_node, s.tile_node_block,
              s.tile_window]
    keep = torch.ones(s.num_tiles, dtype=torch.bool, device=rs.device)
    keep[t0:t1] = False
    parts = {"all": (arrays, rs), "hub": (arrays, rs[h:h + 2]),
             "others": ([a[keep] for a in arrays],
                        torch.cat([rs[:h + 1], rs[h + 2:] - (t1 - t0)]))}

    def call(arrays, bounds):
        return ga.group_aggregate(
            case.feat_p, *arrays, bounds, gs=s.gs, gpt=s.gpt, ont=s.ont,
            src_win=s.src_win, dt=case.dt, out_rows=s.padded_out_rows,
            variant=case.variant)

    rec = {"variant": case.variant, "D": case.d, "tiles": s.num_tiles,
           "runs": s.num_runs, "hub_tiles": t1 - t0,
           "median_run_tiles": float(lens.float().median()),
           "hub_live_slots": int((s.edge_val[t0:t1] != 0).sum()),
           "ms": {k: time_ms(lambda: call(*part), device_only=True)
                  for k, part in parts.items()}}
    log(f"  hub probe: {rec['runs']} runs, hub {rec['hub_tiles']} tiles "
        f"({rec['hub_live_slots']} live slots), median run "
        f"{rec['median_run_tiles']:.0f}; device ms " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["ms"].items()))
    detail["hub_probe"] = rec
    return rec


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
    import torch

    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.launch import serve_gnn

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
        done = [r for r in res["requests"] if r.status == "done"][:4]
        err = _engine_err(eng, done, backend="torch")
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
                   p99_ms=s["p99_ms"],
                   compute_p50_ms=eng.stats.compute.percentile(50) * 1e3,
                   verify_err=res["verify_err"],
                   torch_engine_err=err, seconds=time.time() - t0)
        detail["serving"].append(rec)
        at_serving.setdefault(kname, rec)      # the float32 run comes first
        log(f"{name}: verify={res['verify_err']:.2e} torch-engine={err:.2e} "
            f"kernel at {rec['tiles']} tiles ({rec['live_tiles']} live, "
            f"{rec['edges']} edges) D={rec['D']}: {KernelCase.summary(rec)} "
            f"({time.time() - t0:.1f}s)")
        del res, eng
        torch.cuda.empty_cache()
    return at_serving


# phase 3b: the async tier at phase 3's gcn-f32 widths, three SLO tenants
# (gold / silver / bronze over 250 ms), one schedule of 512 requests
ASYNC_COMMON = SERVE_COMMON + ["--arch", "gcn", "--hidden-dim", "16",
                               "--variant", "folded", "--tenants", "3",
                               "--slo-ms", "250", "--requests", "512"]
ASYNC_RUNS = [("async-deadline", ["--policy", "deadline"]),
              ("async-clock", ["--policy", "clock"]),
              ("async-deadline-deltas", ["--policy", "deadline",
                                         "--stream-deltas", "4"])]


def _engine_err(eng, reqs, backend=None, graph=None, feat=None):
    """Worst ``max|a-b|/(1+|b|)`` of served results against a fresh
    `ServingEngine` (same parameters and serving knobs) on ``backend``
    (default: the engine's) and ``graph``/``feat`` (default: its own)."""
    import dataclasses

    import numpy as np

    from repro_torch.serving import ServingEngine
    cfg = eng.cfg if backend is None else dataclasses.replace(
        eng.cfg, backend=backend)
    fresh = ServingEngine(eng.graph if graph is None else graph,
                          eng.feat if feat is None else feat, cfg,
                          params=eng.params, serving=eng.serving)
    err = 0.0
    for r in reqs:
        ref = fresh.serve_batch([r.seed])[0]
        check(np.isfinite(r.result).all() and r.result.shape == ref.shape,
              f"bad result {r.result}")
        err = max(err, float((np.abs(r.result - ref)
                              / (1.0 + np.abs(ref))).max()))
    return err


def _mutated_inputs(argv):
    """The serve driver's resident graph and features with its
    ``--stream-deltas`` stream applied, rebuilt here from its flags."""
    import numpy as np

    from repro_torch.graphs.csr import random_power_law
    from repro_torch.launch import serve_gnn

    args = serve_gnn.parse_args(argv)
    g = random_power_law(args.num_nodes, args.avg_degree, seed=args.seed)
    feat = np.random.default_rng(args.seed).standard_normal(
        (g.num_nodes, args.in_dim)).astype(np.float32)
    for d in serve_gnn._delta_stream(args, g):
        g = g.apply_delta(d).graph
        new = np.zeros((g.num_nodes - len(feat), args.in_dim), np.float32)
        if d.node_feat is not None:
            new[:len(d.node_feat)] = d.node_feat
        feat = np.concatenate([feat, new])
    return g, feat


def async_serving(detail: dict) -> dict:
    """Phase 3b: `serve_gnn`'s async tier (`ASYNC_RUNS`) at half the
    synchronous gcn-f32 run's req/s of this call; the launch counts are
    zeroed just before each run and read after its engine closed."""
    import collections

    import numpy as np
    import torch

    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.launch import serve_gnn

    kname = ga.KERNEL_OF_VARIANT["folded"]
    sync = [r for r in detail.get("serving", []) if r["phase"] == "gcn-f32"]
    if sync:
        sync_rps, sync_compute = sync[0]["req_per_s"], sync[0][
            "compute_p50_ms"]
    else:
        # this phase alone: a short synchronous run sets the offered rate
        res = serve_gnn.run(SERVE_COMMON + ["--arch", "gcn", "--hidden-dim",
                                            "16", "--requests", "128",
                                            "--variant", "folded"])
        check(res["ok"], "the synchronous gcn-f32 run failed")
        sync_rps = res["summary"]["req_per_s"]
        sync_compute = res["engine"].stats.compute.percentile(50) * 1e3
        del res
    rate = sync_rps / 2
    log(f"async: offered {rate:.1f} req/s (half the synchronous gcn-f32 "
        f"run's {sync_rps:.1f})")
    runs = []
    for name, flags in ASYNC_RUNS:
        t0 = time.time()
        ga.reset_launches()
        res = serve_gnn.run(ASYNC_COMMON + flags + ["--rate", str(rate)])
        counts = dict(ga.launches)           # after the engine's close()
        eng, acc = res["engine"], res["accounting"]
        reasons = collections.Counter(r.reject_reason
                                      for r in res["all_requests"]
                                      if r.status == "rejected")
        compute_p50 = eng.stats.compute.percentile(50) * 1e3
        log(f"{name}: launches={ {k: v for k, v in counts.items() if v} } "
            f"accounting={acc} rejections={dict(reasons)} "
            f"throughput={res['throughput_rps']:.1f} req/s "
            f"serve_batch p50={compute_p50:.1f}ms (synchronous run "
            f"{sync_compute:.1f}ms) updates={res['updates']} "
            f"update_errors={res['update_errors']}")
        for tenant, st in res["summary"].items():
            log(f"  {tenant} ({st['slo_class']} {st['slo_ms']:.0f}ms): "
                f"p50={st['p50_ms']:.1f}ms p99={st['p99_ms']:.1f}ms "
                f"attainment={st['slo_attainment']:.3f} "
                f"mean-batch={st['mean_batch']:.2f} "
                f"batches={st['batches']}")
        check(res["ok"], f"{name}: serve_gnn accounting/verify failed "
              f"(verify err {res['verify_err']})")
        check(acc["submitted"] == acc["completed"] + acc["rejected"]
              and acc["outstanding"] == 0 and acc["rejected"] == 0,
              f"{name}: accounting {acc}, rejections {dict(reasons)}")
        check(counts[kname] > 0, f"{name}: {kname} never launched")
        for other, c in counts.items():
            check(other == kname or c == 0,
                  f"{name}: {other} launched {c} times on the main path")
        deltas = "--stream-deltas" in flags
        if deltas:
            check(res["updates"] == 4 and res["update_errors"] == 0,
                  f"{name}: {res['updates']} updates applied, "
                  f"{res['update_errors']} failed")
        # the last chunk (answered on the final snapshot) against the
        # plain versions, and against a fresh engine built on the mutated
        # graph; without deltas the first requests
        done = [r for r in res["requests"] if r.status == "done"][:4]
        torch_err = _engine_err(eng, done, backend="torch")
        fresh_err = None
        if deltas:
            g2, feat2 = _mutated_inputs(ASYNC_COMMON + flags)
            check(np.array_equal(g2.indptr, eng.graph.indptr)
                  and np.array_equal(g2.indices, eng.graph.indices)
                  and np.array_equal(feat2, eng.feat),
                  f"{name}: the engine's graph is not the four deltas "
                  f"applied to the resident graph")
            fresh_err = _engine_err(eng, done, graph=g2, feat=feat2)
        check(torch_err <= TOL, f"{name}: kernel engine vs torch engine "
              f"{torch_err:.2e} > {TOL}")
        if deltas:
            check(fresh_err <= TOL, f"{name}: after the deltas vs a fresh "
                  f"engine on the mutated graph {fresh_err:.2e} > {TOL}")
        rec = {"phase": name, "flags": flags, "rate_rps": rate,
               "sync_rps": sync_rps, "launches": counts[kname],
               "accounting": acc, "throughput_rps": res["throughput_rps"],
               "verify_err": res["verify_err"], "torch_engine_err": torch_err,
               "fresh_engine_err": fresh_err, "updates": res["updates"],
               "update_errors": res["update_errors"],
               "graph_epoch": eng.graph_epoch,
               "serve_batch_p50_ms": compute_p50,
               "sync_serve_batch_p50_ms": sync_compute,
               "tenants": res["summary"], "seconds": time.time() - t0}
        runs.append(rec)
        log(f"{name}: verify={res['verify_err']:.2e} "
            f"torch-engine={torch_err:.2e} "
            f"fresh-engine={'-' if fresh_err is None else f'{fresh_err:.2e}'}"
            f" ({rec['seconds']:.1f}s)")
        del res, eng
        torch.cuda.empty_cache()
    detail["async"] = runs
    return {"launches": sum(r["launches"] for r in runs)}


class EdgeGradCase(KernelCase):
    """One edge-gradient kernel call at one shape: padded cotangent and
    features exactly as `kernels.ops._edge_cotangent` hands them to the
    wrapper, the plain version on the same inputs, the library yardstick
    and the bound.  Only real slots are compared (padded slots and pad
    tiles are don't-care)."""

    def __init__(self, sched, graph, d, dtype, variant, dt, seed,
                 device="cuda"):
        import torch

        from repro_torch.kernels.ops import _pad_to, dim_tile
        gen = torch.Generator(device=device).manual_seed(seed)
        self.s, self.variant, self.d = sched, variant, d
        n = sched.num_nodes
        grad = torch.randn((n, d), generator=gen, device=device).to(dtype)
        feat = torch.randn((n, d), generator=gen, device=device).to(dtype)
        self.dt = dim_tile(dt, d, dtype)
        d_pad = -(-d // self.dt) * self.dt
        self.grad_p = _pad_to(grad, sched.padded_out_rows, d_pad)
        self.feat_p = _pad_to(feat, sched.padded_src_rows, d_pad)
        # the library yardstick: one SDDMM on the graph's CSR pattern,
        # out[e] = <grad[row e], feat[col e]> (f32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # "sparse CSR is beta"
            self.csr = torch.sparse_csr_tensor(
                torch.as_tensor(graph.indptr, device=device),
                torch.as_tensor(graph.indices, dtype=torch.int64,
                                device=device),
                torch.ones(graph.num_edges, device=device), size=(n, n),
                check_invariants=False)
        self.grad32 = grad.float()
        self.feat32_t = feat.float().t().contiguous()
        # 4 B id + 4 B result per real edge, 4 B per group holding an edge,
        # the source rows and cotangent rows edges read (feature dtype)
        edges, groups, n_src, n_dst = real_work(sched)
        self.bound_ms, self.bound_by = bound(
            8 * edges + 4 * groups + (n_src + n_dst) * d * feat.element_size(),
            2.0 * edges * d)
        T, gpt, gs = sched.nbrs.shape
        self.shape = {"tiles": T, "live_tiles": sched.live_tiles, "gpt": gpt,
                      "gs": gs, "src_win": sched.src_win, "nodes": n,
                      "edges": edges, "src_rows": n_src, "out_rows": n_dst,
                      "D": d, "dt": self.dt,
                      "dtype": str(dtype).removeprefix("torch."),
                      "runs": sched.num_runs}

    def _real(self, per_slot):
        s = self.s
        return per_slot.reshape(-1, s.gs)[s.edge_slot, s.edge_pos]

    def kernel(self):
        from repro_torch.kernels.group_aggregate import group_edge_grad
        s = self.s
        return group_edge_grad(
            self.grad_p, self.feat_p, s.nbrs, s.local_node,
            s.tile_node_block, s.tile_window, s.run_start, gs=s.gs,
            gpt=s.gpt, ont=s.ont, src_win=s.src_win, dt=self.dt,
            variant=self.variant, slot_of_edge=s.slot_of_edge)

    def plain(self):
        from repro_torch.kernels.group_aggregate import group_edge_grad_plain
        s = self.s
        return group_edge_grad_plain(self.grad_p, self.feat_p, s.nbrs,
                                     s.local_node, s.tile_node_block,
                                     ont=s.ont)

    def oracle(self, grad, feat):
        """The per-slot dots in float64 (uncounted witness)."""
        import torch

        from repro_torch.kernels.ref import group_edge_grad_ref
        s = self.s
        return group_edge_grad_ref(grad, feat, s.nbrs, s.local_node,
                                   s.tile_node_block, s.ont,
                                   acc_dtype=torch.float64)

    def library(self):
        import torch
        return torch.sparse.sampled_addmm(self.csr, self.grad32,
                                          self.feat32_t, beta=0.0)

    def check(self) -> dict:
        """Kernel vs plain version, and both vs the float64 witness within
        the float32 summation bound of a D-term dot product."""
        import torch
        k = self._real(self.kernel())
        # no atomics and a fixed summation order: bit-identical reruns
        check(torch.equal(k, self._real(self.kernel())),
              f"{self.variant}: two edge-gradient calls differ at "
              f"{self.shape}")
        k = k.double()
        p = self._real(self.plain()).double()
        g, f = self.grad_p.double(), self.feat_p.double()
        exact = self._real(self.oracle(g, f))
        mag = self._real(self.oracle(g.abs(), f.abs()))
        check(bool(torch.isfinite(k).all()),
              f"non-finite edge-gradient output {self.shape}")
        terms = float(self.d)
        limit = terms * U32 / (1.0 - terms * U32) * mag

        def over_bound(x):
            err = (x - exact).abs()
            return float(torch.where(
                limit > 0, err / limit.clamp_min(1e-300),
                torch.where(err > 0, torch.inf, 0.0)).max())

        diff = (k - p).abs()
        return dict(self.shape, variant=self.variant,
                    max_abs_err=float(diff.max()),
                    max_err=float((diff / (1.0 + p.abs())).max()),
                    max_err_scaled=float((diff / (1.0 + mag)).max()),
                    err_f64=float(((k - exact).abs()
                                   / (1.0 + exact.abs())).max()),
                    plain_err_f64=float(((p - exact).abs()
                                         / (1.0 + exact.abs())).max()),
                    over_bound=over_bound(k), plain_over_bound=over_bound(p),
                    bound_ms=self.bound_ms, bound_by=self.bound_by)



def _lib(rec: dict) -> str:
    v = rec["library_ms"]
    return ("n/a" if v is None else
            f"{v:.4f} (device {rec['library_device_ms']:.4f})")


# phase 4's GAT schedules of the pubmed replica: (name, variant, pinned
# config or None for the tuner's pick).  gs 128 is past the 64 slots a
# group the earlier direct kernel held; Eq. 3 allows it at dt <= 512.
EDGE_GRAD_SCHEDULES = [
    ("slot_onehot", "slot_onehot", None),
    ("direct", "direct", None),
    ("direct-gs128", "direct",
     dict(gs=128, gpt=8, dt=128, src_win=512, variant="direct")),
]


def edge_grad_checks(detail: dict) -> list:
    """Phase 4: the edge-gradient kernel vs its plain version on the pubmed
    replica's GAT schedules (`EDGE_GRAD_SCHEDULES`), then the autograd
    Function."""
    import torch

    from repro_torch.core.advisor import plan_for
    from repro_torch.core.model import AggConfig
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.kernels.ops import aggregate
    from repro_torch.kernels.ref import group_aggregate_ref, group_edge_grad_ref

    t0 = time.time()
    g, _, _ = make_dataset("pubmed", max_dim=1)
    records, grads = [], []
    for name, variant, pinned in EDGE_GRAD_SCHEDULES:
        t1 = time.time()
        plan = plan_for(g, arch="gat", in_dim=128, hidden_dim=16,
                        tune_iters=4, variant=variant, with_backward=True,
                        config=None if pinned is None else AggConfig(**pinned))
        sched, sched_bwd = plan.sched("cuda"), plan.sched_bwd("cuda")
        cfg = plan.config
        kname = ga.EDGE_GRAD_KERNEL_OF_VARIANT[variant]
        log(f"pubmed gat {name} ({kname}): gs={cfg.gs} gpt={cfg.gpt} "
            f"dt={cfg.dt} src_win={cfg.src_win} tiles={sched.num_tiles} "
            f"runs={sched.num_runs} bwd tiles={sched_bwd.num_tiles} "
            f"runs={sched_bwd.num_runs} (plan {time.time() - t1:.1f}s)")
        for d in (1, 16, 128):
            for dtype in (torch.float32, torch.bfloat16):
                case = EdgeGradCase(sched, plan.graph, d, dtype, variant,
                                    cfg.dt, seed=d)
                rec = dict(case.run(), graph="pubmed", kernel=kname,
                           schedule=name)
                records.append(rec)
                log(f"  D={d} {rec['dtype']}: {KernelCase.summary(rec)}")
                KernelCase.holds(rec, f"pubmed {name} {kname}")
                del case

        # the autograd Function on the card, cuda vs torch backends
        gen = torch.Generator(device="cuda").manual_seed(5)
        n, e = g.num_nodes, g.num_edges
        feat = torch.randn((n, 16), generator=gen, device="cuda")
        cot = torch.randn((n, 16), generator=gen, device="cuda")
        ev = 0.5 + torch.rand((e,), generator=gen, device="cuda")
        out = {}
        for backend in ("cuda", "torch"):
            f = feat.clone().requires_grad_(True)
            w = ev.clone().requires_grad_(True)
            y = aggregate(f, sched, dt=cfg.dt, backend=backend,
                          variant=variant, edge_values=w,
                          sched_bwd=sched_bwd)
            (y * cot).sum().backward()
            out[backend] = (f.grad.double(), w.grad.double())
        # magnitudes the float32 sums run over: |cot| aggregated over the
        # transposed schedule with |ev|, and sum|cot[dst] * feat[src]|
        ev_bwd = ev.abs()[sched_bwd.edge_perm]
        evs = torch.zeros(sched_bwd.nbrs.numel() // sched_bwd.gs,
                          sched_bwd.gs, device="cuda")
        evs[sched_bwd.edge_slot, sched_bwd.edge_pos] = ev_bwd
        mag_f = group_aggregate_ref(
            torch.nn.functional.pad(cot.abs(), (0, 0, 0,
                                                sched_bwd.padded_src_rows - n)),
            sched_bwd.nbrs, evs.reshape(sched_bwd.nbrs.shape),
            sched_bwd.local_node, sched_bwd.tile_node_block, sched_bwd.ont,
            sched_bwd.padded_out_rows, acc_dtype=torch.float64)[:n]
        per_slot = group_edge_grad_ref(
            torch.nn.functional.pad(cot.abs(), (0, 0, 0,
                                                sched.padded_out_rows - n)),
            torch.nn.functional.pad(feat.abs(), (0, 0, 0,
                                                 sched.padded_src_rows - n)),
            sched.nbrs, sched.local_node, sched.tile_node_block, sched.ont,
            acc_dtype=torch.float64)
        mag_e = per_slot.reshape(-1, sched.gs)[sched.edge_slot,
                                               sched.edge_pos]
        (kf, ke), (pf, pe) = out["cuda"], out["torch"]
        rec = {"schedule": name, "variant": variant,
               "feat_err_scaled": float(((kf - pf).abs() / (1 + mag_f)).max()),
               "feat_err": float(((kf - pf).abs() / (1 + pf.abs())).max()),
               "ev_err_scaled": float(((ke - pe).abs() / (1 + mag_e)).max()),
               "ev_err": float(((ke - pe).abs() / (1 + pe.abs())).max())}
        grads.append(rec)
        log(f"  autograd cuda vs torch: feat {rec['feat_err_scaled']:.2e} "
            f"(/(1+|p|) {rec['feat_err']:.2e}) edge values "
            f"{rec['ev_err_scaled']:.2e} (/(1+|p|) {rec['ev_err']:.2e})")
        check(rec["feat_err_scaled"] <= TOL and rec["ev_err_scaled"] <= TOL,
              f"{name}: autograd cuda vs torch beyond {TOL}: {rec}")
        del sched, sched_bwd, plan
        torch.cuda.empty_cache()
    detail["edge_grad"] = records
    detail["autograd"] = grads
    log(f"edge-gradient checks done ({time.time() - t0:.1f}s)")
    return records


TRAIN_STEPS = 20
TRAIN_COMMON = ["--dataset", "pubmed", "--max-nodes", "19717",
                "--hidden-dim", "16", "--steps", str(TRAIN_STEPS),
                "--lr", "1e-2", "--warmup", "2", "--ckpt-every", "10",
                "--device", "cuda", "--backend", "cuda"]
# (phase, arch, variant, dtype, forward-kernel launches per step,
#  edge-gradient launches per step, teacher forward aggregations)
TRAIN_PHASES = [
    ("gat-slot-f32", "gat", "slot_onehot", "float32", 6, 4, 4),
    ("gat-direct-f32", "gat", "direct", "float32", 6, 4, 4),
    ("gcn-folded-f32", "gcn", "folded", "float32", 4, 0, 2),
    ("gcn-folded-bf16", "gcn", "folded", "bfloat16", 4, 0, 2),
]


def training(detail: dict) -> dict:
    """Phase 5: the training main path, one run per (arch, variant,
    dtype); returns the edge-gradient kernel's records at the training
    shape, keyed by `EDGE_GRAD_RECORDS` name."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.core.aggregate import PlanExecutor
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.launch import train
    from repro_torch.models.gnn import make_gnn_train_step
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)

    at_training = {}
    detail["training"] = []
    for name, arch, variant, dtype, fwd_per, edge_per, teacher in TRAIN_PHASES:
        t0 = time.time()
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        fname = ga.KERNEL_OF_VARIANT[variant]
        ename = ga.EDGE_GRAD_KERNEL_OF_VARIANT[variant]
        want = {k: 0 for k in ga.launches}
        want[fname] = TRAIN_STEPS * fwd_per
        want[ename] += TRAIN_STEPS * edge_per
        want[ga.PLAIN] = teacher
        try:
            ga.reset_launches()
            res = train.run(TRAIN_COMMON + ["--arch", arch, "--variant",
                                            variant, "--dtype", dtype,
                                            "--ckpt-dir", ckpt])
            counts = dict(ga.launches)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        hist = res["history"]
        losses = [m["loss"] for m in hist]
        log(f"{name}: launches={ {k: v for k, v in counts.items() if v} } "
            f"steps={len(hist)} loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"avg_step={res['avg_step_s'] * 1e3:.2f}ms")
        check(res["ok"] and len(hist) == TRAIN_STEPS,
              f"{name}: training did not run {TRAIN_STEPS} finite steps")
        check(counts == want, f"{name}: launch counts {counts} != {want}")
        check(losses[-1] < losses[0],
              f"{name}: loss did not fall ({losses[0]} -> {losses[-1]})")
        # three steps on each backend from the run's initial parameters
        model, batch = res["model"], res["batch"]
        opt = AdamWConfig(lr=1e-2, schedule=cosine_schedule(2, TRAIN_STEPS))
        torch_model = dataclasses.replace(
            model, cfg=dataclasses.replace(model.cfg, backend="torch"),
            executor=PlanExecutor(model.plan, backend="torch",
                                  device="cuda"))
        finals = []
        for m in (model, torch_model):
            step = make_gnn_train_step(m, opt)
            params = {k: v.clone() for k, v in res["init_params"].items()}
            state = (params, adamw_init(params))
            for _ in range(3):
                state, _ = step(state, batch)
            finals.append(state[0])
        param_err = max(float(((finals[0][k] - finals[1][k]).abs()
                               / (1 + finals[1][k].abs())).max())
                        for k in finals[0])
        log(f"{name}: 3 steps cuda vs torch, params {param_err:.2e}")
        check(param_err <= 1e-4, f"{name}: cuda vs torch parameters "
              f"{param_err:.2e} > 1e-4")
        rec = {"phase": name, "arch": arch, "variant": variant,
               "dtype": dtype, "steps": len(hist), "launches": counts,
               "forward_per_step": fwd_per, "edge_grad_per_step": edge_per,
               "first_loss": losses[0], "last_loss": losses[-1],
               "avg_step_ms": res["avg_step_s"] * 1e3,
               "steps_per_s": 1.0 / res["avg_step_s"],
               "step_ms": [m["step_time_s"] * 1e3 for m in hist],
               "param_err": param_err,
               "tiles": model.plan.partition.num_tiles,
               "bwd_tiles": model.plan.partition_bwd.num_tiles,
               "config": dataclasses.asdict(model.plan.config)}
        if edge_per:
            # the edge-gradient kernel at this run's hidden-width shape
            ex = model.executor
            case = EdgeGradCase(ex.sched, model.plan.graph,
                                model.cfg.hidden_dim, model.cfg.compute_dtype,
                                variant, model.plan.config.dt, seed=9)
            krec = case.run()
            KernelCase.holds(krec, f"{name}: {ename} at the training shape")
            krec.update(phase=name, launches=counts[ename],
                        launches_per_step=edge_per)
            at_training[EDGE_GRAD_RECORDS[variant]] = krec
            rec["edge_grad_kernel"] = krec
            log(f"{name}: {ename} at {krec['tiles']} tiles ({krec['edges']} "
                f"edges) D={krec['D']}: {KernelCase.summary(krec)}")
            del case
        if variant == "direct":
            # the gather kernel on this run's schedule: at the input width
            # (128) and at the widths a GAT step aggregates (hidden, and 1
            # for the softmax denominator)
            ex = model.executor
            rec["gather_kernel"] = []
            for d in (batch["feat"].shape[1], model.cfg.hidden_dim, 1):
                case = KernelCase(ex.sched, model.plan.graph,
                                  model.plan.partition.edge_values_csr(), d,
                                  model.cfg.compute_dtype, variant,
                                  model.plan.config.dt, seed=10)
                grec = case.run()
                KernelCase.holds(grec, f"{name}: {fname} at D {d}")
                rec["gather_kernel"].append(grec)
                log(f"{name}: {fname} at {grec['tiles']} tiles "
                    f"({grec['edges']} edges) D={d}: "
                    f"{KernelCase.summary(grec)}")
                del case
        rec["seconds"] = time.time() - t0
        detail["training"].append(rec)
        del res, model, torch_model, batch, finals
        torch.cuda.empty_cache()
    return at_training


SAMPLED_STEPS = 20
SAMPLED_COMMON = ["--sampled", "--dataset", "reddit", "--scale", "1.0",
                  "--fanouts", "10,5", "--batch-nodes", "512",
                  "--warmup", "2", "--ckpt-every", "10", "--device", "cuda",
                  "--backend", "cuda", "--variant", "folded"]
# (job, arch, hidden, dtype, learning rate, folded launches per step, the
#  layers whose transposed schedule a step launches: block 0's raw features
#  take no gradient in GIN, whose first aggregation reads them directly).
#  GIN's sum aggregation over reddit's scaled edge values starts its logits
#  near 1e4; at lr 1e-2 its ReLUs die within 20 steps (loss ln 41, gradient
#  0), so it trains at 1e-3.  The stream job swaps an interaction-stream
#  delta into the loader's resident graph every 5 steps (8 steps: one swap,
#  before step 5, about 20 s of the trainer's thread at full reddit); its
#  checks read the three batches after it.
STREAM_EVERY, STREAM_STEPS = 5, 8
SAMPLED_JOBS = [
    ("sampled-gcn-f32", "gcn", 16, "float32", 1e-2, 4, (0, 1),
     SAMPLED_STEPS, []),
    ("sampled-gcn-bf16", "gcn", 16, "bfloat16", 1e-2, 4, (0, 1),
     SAMPLED_STEPS, []),
    ("sampled-gin-f32", "gin", 64, "float32", 1e-3, 3, (1,),
     SAMPLED_STEPS, []),
    ("sampled-gcn-f32-stream", "gcn", 16, "float32", 1e-2, 4, (0, 1),
     STREAM_STEPS, ["--stream-deltas", str(STREAM_EVERY)]),
]


def _span_ms(doc: dict, path: str, skip: int = 1) -> float:
    """Median of a span's durations in the run's metrics document (ms),
    dropping the first ``skip``."""
    ds = [r["duration_s"] for r in doc["spans"] if r["span"] == path]
    return 1e3 * statistics.median(ds[skip:]) if len(ds) > skip else None


def sampled_training(detail: dict) -> list:
    """Phase 5b: neighbor-sampled training on the full reddit replica
    through `repro_torch.launch.train.run(--sampled)`, one job per
    `SAMPLED_JOBS` row; returns the folded kernel's records at the block
    shapes (phase-2 checks and times), with ``launches`` the jobs'."""
    import dataclasses
    import shutil
    import tempfile
    from unittest import mock

    import torch

    from repro_torch.core.aggregate import PlanExecutor
    from repro_torch.core.partition import transpose_graph
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.launch import train
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)
    from repro_torch.sampling import SampledLoader, SampledTrainStep

    build = SampledLoader.batch_for

    fname = ga.KERNEL_OF_VARIANT["folded"]
    records = []
    detail["sampled"] = []
    for (name, arch, hidden, dtype, lr, per_step, bwd_layers, steps,
         extra) in SAMPLED_JOBS:
        t0 = time.time()
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        want = {k: 0 for k in ga.launches}
        want[fname] = steps * per_step
        # keep every batch the run's loader builds (on its worker thread;
        # the loader is pure in the step index, so these are the batches
        # the steps consumed): the checks below reuse them, since one
        # reddit batch takes seconds of host work to build again
        built = {}

        def keep(loader, step):
            built[step] = build(loader, step)
            return built[step]

        try:
            ga.reset_launches()
            with mock.patch.object(SampledLoader, "batch_for", keep):
                res = train.run(SAMPLED_COMMON + extra + [
                    "--arch", arch, "--hidden-dim", str(hidden), "--dtype",
                    dtype, "--lr", str(lr), "--steps", str(steps),
                    "--ckpt-dir", ckpt])
            counts = dict(ga.launches)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        hist, st, cfg = res["history"], res["stats"], res["cfg"]
        losses = [m["loss"] for m in hist]
        grad_norms = [m["grad_norm"] for m in hist]
        log(f"{name}: launches={ {k: v for k, v in counts.items() if v} } "
            f"steps={len(hist)} loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"grad_norm {grad_norms[0]:.4g} -> {grad_norms[-1]:.4g} "
            f"avg_step={res['avg_step_s'] * 1e3:.2f}ms "
            f"sample_p50={st['sample_p50_ms']:.1f}ms "
            f"stall_p99={st['prefetch_stall_p99_ms']:.1f}ms "
            f"hit_rate={st['cache']['hit_rate']:.3f} "
            f"buckets={st['num_buckets']}")
        check(res["ok"] and len(hist) == steps,
              f"{name}: training did not run {steps} finite steps")
        check(counts == want, f"{name}: launch counts {counts} != {want}")
        first5, last5 = (statistics.mean(losses[:5]),
                         statistics.mean(losses[-5:]))
        check(last5 < first5, f"{name}: mean loss of the last five steps "
              f"{last5} is not below the first five's {first5}")
        # a network whose ReLUs all died also lowers the loss (to ln C):
        # it must still take a gradient at each of the last five steps
        check(min(grad_norms[-5:]) > 0, f"{name}: a zero gradient in the "
              f"last five steps {grad_norms[-5:]} (dead network)")

        loader, stream = res["loader"], res["stream"]
        check(set(range(steps)) <= set(built),
              f"{name}: the loader built steps {sorted(built)}")
        first = 0
        if stream is not None:
            due = list(range(STREAM_EVERY, steps, STREAM_EVERY))
            log(f"{name}: deltas applied before steps {stream.applied_at}, "
                f"graph epoch {st['graph_epoch']}, swaps "
                f"{st['graph_swaps']}, nodes {loader.g.num_nodes}")
            check(stream.applied_at == due
                  and st["graph_swaps"] == st["graph_epoch"] == len(due),
                  f"{name}: deltas applied at {stream.applied_at}, swaps "
                  f"{st['graph_swaps']}, want {due}")
            # every consumed batch was built from the graph of its step
            epochs = [built[s].graph_epoch for s in range(steps)]
            check(epochs == [sum(a <= s for a in due) for s in range(steps)],
                  f"{name}: batches' graph epochs {epochs}")
            first = due[0]
        raw = [built[s].raw_edges for s in range(steps)]
        big = max(range(first, steps), key=lambda s: raw[s][0])
        # three steps on each backend from the run's initial parameters,
        # on the run's first three batches (after the first swap)
        opt = AdamWConfig(lr=lr, schedule=cosine_schedule(2, steps))
        batches = [built[s] for s in range(first, first + 3)]
        on_torch = [dataclasses.replace(b, entries=[dataclasses.replace(
            e, executor=PlanExecutor(e.plan, backend="torch",
                                     device=loader.device))
            for e in b.entries]) for b in batches]
        finals, alone_ms = [], []
        for bs, backend in ((batches, "cuda"), (on_torch, "torch")):
            step = SampledTrainStep(dataclasses.replace(cfg, backend=backend),
                                    opt)
            params = {k: v.clone() for k, v in res["init_params"].items()}
            state = (params, adamw_init(params))
            for b in bs:
                t1 = time.perf_counter()
                state, m = step(state, b)
                float(m["loss"])            # waits for the step's kernels
                if backend == "cuda":
                    alone_ms.append(1e3 * (time.perf_counter() - t1))
            finals.append(state[0])
            if backend == "cuda":
                # one more step, on the largest batch, under the profiler:
                # the device's share of a step with no loader work beside it
                # (with the wrapper's count of its launches, to read the
                # profiler's kernel rows against)
                before = ga.launches[fname]
                prof = _profile(lambda: step(state, built[big]))
                prof["folded_launches"] = ga.launches[fname] - before
        param_err = max(float(((finals[0][k] - finals[1][k]).abs()
                               / (1 + finals[1][k].abs())).max())
                        for k in finals[0])
        log(f"{name}: 3 steps cuda vs torch from step {first}, params "
            f"{param_err:.2e}")
        check(param_err <= 1e-4, f"{name}: cuda vs torch parameters "
              f"{param_err:.2e} > 1e-4")
        del batches, on_torch, finals

        batch = built[big]
        widths = ([hidden, cfg.num_classes] if arch == "gcn"
                  else [cfg.in_dim, hidden])
        blocks = []
        for layer, ent in enumerate(batch.entries):
            ex, plan = ent.executor, ent.plan
            # rows past the block's dst nodes hold no edge: exact zeros
            x = torch.randn((ex.sched.num_nodes, widths[layer]),
                            device=loader.device).to(cfg.compute_dtype)
            raw_dst = (batch.raw_nodes[layer + 1]
                       if layer + 1 < len(batch.raw_nodes)
                       else batch.num_seeds)
            with torch.no_grad():
                out = ex(x)
            check(bool((out[raw_dst:] == 0).all()),
                  f"{name}: block {layer} rows past its {raw_dst} dst nodes "
                  f"are not exact zeros")
            ev = plan.partition.edge_values_csr()
            gT, ev_t, _ = transpose_graph(plan.graph, ev)
            scheds = [("fwd", ex.sched, plan.graph, ev)]
            if layer in bwd_layers:
                scheds.append(("bwd", ex.sched_bwd, gT, ev_t))
            for direction, sched, graph, vals in scheds:
                case = KernelCase(sched, graph, vals, widths[layer],
                                  cfg.compute_dtype, "folded",
                                  plan.config.dt, seed=11)
                krec = case.run()
                KernelCase.holds(krec, f"{name}: {fname} block {layer} "
                                 f"{direction}")
                krec.update(phase=name, layer=layer, direction=direction,
                            step=big, raw_nodes=batch.raw_nodes[layer],
                            raw_edges=batch.raw_edges[layer],
                            dst_nodes=raw_dst)
                blocks.append(krec)
                log(f"{name}: {fname} block {layer} {direction} at "
                    f"{krec['tiles']} tiles ({krec['live_tiles']} live, "
                    f"{krec['edges']} edges, {krec['nodes']} nodes) "
                    f"D={krec['D']}: {KernelCase.summary(krec)}")
                del case
        rec = {"phase": name, "arch": arch, "hidden": hidden,
               "dtype": dtype, "steps": len(hist), "launches": counts,
               "deltas_applied_at": (None if stream is None
                                     else stream.applied_at),
               "graph_epoch": st["graph_epoch"],
               "launches_per_step": per_step, "first_loss": losses[0],
               "last_loss": losses[-1], "first5_loss": first5,
               "last5_loss": last5, "lr": lr, "grad_norms": grad_norms,
               "avg_step_ms": res["avg_step_s"] * 1e3,
               "step_ms": [m["step_time_s"] * 1e3 for m in hist],
               "wall_step_ms": _span_ms(res["doc"], "train/step"),
               "batch_wait_ms": _span_ms(res["doc"], "train/step/batch"),
               "sample_p50_ms": st["sample_p50_ms"],
               "prefetch_stall_p99_ms": st["prefetch_stall_p99_ms"],
               "cache": st["cache"], "num_buckets": st["num_buckets"],
               "batches_built": st["batches_built"],
               "raw_edges": [list(r) for r in raw], "largest_step": big,
               "largest_raw_nodes": list(batch.raw_nodes),
               "param_err": param_err, "step_alone_ms": alone_ms,
               "step_profile": prof,
               "kernel_device_ms_per_step": sum(
                   r["device_ms"] for r in blocks),
               "blocks": blocks, "seconds": time.time() - t0}
        log(f"{name}: wall step {rec['wall_step_ms']:.2f}ms (batch wait "
            f"{rec['batch_wait_ms']:.2f}ms); a step alone "
            f"{statistics.median(alone_ms):.2f}ms, under the profiler "
            f"{prof['wall_ms']:.2f}ms with {prof['device_ms']:.4f}ms on "
            f"device (idle {prof['idle_share']:.3f}); folded device "
            f"{rec['kernel_device_ms_per_step']:.4f}ms a step; blocks of "
            f"step {big}: raw nodes {list(batch.raw_nodes)} edges "
            f"{list(batch.raw_edges)}; {rec['seconds']:.1f}s")
        for r in blocks:
            r["launches"] = counts[fname]
        records.extend(blocks)
        detail["sampled"].append(rec)
        del res, loader, batch, built
        torch.cuda.empty_cache()
    return records


def gcn_plan_delta(delta, num_nodes: int):
    """Mirror a raw-graph delta onto a GCN plan graph, which carries a
    self-loop on every node: new nodes get theirs, and deleted nodes get
    theirs back (deleting a node empties its row; the id survives)."""
    import dataclasses

    import numpy as np

    def ids(x):
        return np.asarray([] if x is None else x, np.int64).ravel()

    loops = np.concatenate([
        np.arange(num_nodes, num_nodes + delta.num_new_nodes, dtype=np.int64),
        ids(delta.del_nodes)])
    return dataclasses.replace(
        delta, add_src=np.concatenate([ids(delta.add_src), loops]),
        add_dst=np.concatenate([ids(delta.add_dst), loops]), add_val=None)


def ahat_values(g):
    """GCN's A-hat weights of a graph that already carries its self-loops
    (`models.gnn.gcn_edge_values` without adding them)."""
    import numpy as np
    inv = 1.0 / np.sqrt(np.maximum(g.degrees.astype(np.float64), 1.0))
    rows, cols = g.to_coo()
    return (inv[rows] * inv[cols]).astype(np.float32)


def dynamic_plans(detail: dict) -> list:
    """Phase 5c: `Plan.apply_delta` on the kernels.  One interaction-stream
    delta (1% of the nodes' worth of edge churn, as the reference's
    dynamic benchmark sizes it) patches phase 2's gather plan of the full
    reddit replica and a train-ready folded GCN plan of the pubmed
    replica; each patched schedule (forward, and transposed where the
    plan has one) is held against the plain version, the float64 witness
    and the kernel on a fresh partition of the mutated graph at the same
    config, and the autograd Function's feature gradient on the patched
    pubmed pair against ``backend="torch"``."""
    import torch

    from repro_torch.core.advisor import plan_for
    from repro_torch.core.incremental import dirty_block_fraction
    from repro_torch.core.partition import partition_graph, transpose_graph
    from repro_torch.graphs.csr import random_power_law
    from repro_torch.graphs.datasets import interaction_stream, make_dataset
    from repro_torch.kernels.ops import DeviceSchedule, aggregate
    from repro_torch.kernels.ref import group_aggregate_ref
    from repro_torch.models.gnn import gcn_edge_values

    t0 = time.time()
    if "reddit" in SHARED:
        raw_r, reddit, vals_r = SHARED["reddit"]
    else:
        raw_r = make_dataset("reddit", max_dim=1)[0]
        reddit, vals_r = gcn_edge_values(raw_r)
    plan_r = SHARED.get("reddit_plan") or plan_for(
        reddit, arch="gcn", in_dim=64, hidden_dim=64, edge_vals=vals_r,
        tune_iters=4, variant="direct")
    raw_p = random_power_law(19717, 4.5, seed=0)
    pubmed, vals_p = gcn_edge_values(raw_p)
    plan_p = plan_for(pubmed, arch="gcn", in_dim=16, hidden_dim=16,
                      edge_vals=vals_p, tune_iters=4, variant="folded",
                      with_backward=True)
    log(f"dynamic: plans ready ({time.time() - t0:.1f}s)")
    # (name, raw graph, plan, variant, planning width, widths, dtypes)
    cases = [("reddit", raw_r, plan_r, "direct", 64, (64,), (torch.float32,)),
             ("pubmed", raw_p, plan_p, "folded", 16, (16,),
              (torch.float32, torch.bfloat16))]
    records, host = [], []
    for name, raw, plan, variant, dim, widths, dtypes in cases:
        cfg = plan.config
        wb = plan.partition_bwd is not None
        eb = max(64, raw.num_nodes // 100)
        delta = next(interaction_stream(raw, num_batches=1,
                                        edges_per_batch=eb, seed=0))
        # the dirty share a delta of 1% of the EDGES would give
        big = next(interaction_stream(raw, num_batches=1,
                                      edges_per_batch=raw.num_edges // 100,
                                      seed=0))
        res_big = raw.apply_delta(big)
        frac_big = dirty_block_fraction(res_big.dirty_rows,
                                        res_big.graph.num_nodes, cfg.ont)
        del res_big, big
        t1 = time.perf_counter()
        plan2 = plan.apply_delta(gcn_plan_delta(delta, plan.graph.num_nodes),
                                 edge_vals=ahat_values)
        t_inc = time.perf_counter() - t1
        g2 = plan2.graph
        ev2 = ahat_values(g2)
        t1 = time.perf_counter()
        plan_for(g2, arch="gcn", in_dim=dim, hidden_dim=dim, edge_vals=ev2,
                 tune_iters=4, variant=variant, with_backward=wb)
        t_scratch = time.perf_counter() - t1
        t1 = time.perf_counter()
        knobs = dict(gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont, src_win=cfg.src_win)
        fresh = [("fwd", plan2.partition, None, partition_graph(
            g2, edge_vals=ev2, **knobs), g2, ev2)]
        if wb:
            gT, evT, _ = transpose_graph(g2, ev2)
            fresh.append(("bwd", plan2.partition_bwd, plan2.edge_perm_bwd,
                          partition_graph(gT, edge_vals=evT, **knobs), gT,
                          evT))
        t_repart = time.perf_counter() - t1
        st = plan2.stats
        h = {"graph": name, "nodes": g2.num_nodes, "edges": g2.num_edges,
             "delta_edges": eb, "mode": st["incremental"],
             "dirty_fraction": st["dirty_fraction"],
             "dirty_fraction_1pct_edges": frac_big, "tiles": st["tiles"],
             "apply_delta_ms": 1e3 * t_inc, "plan_for_ms": 1e3 * t_scratch,
             "repartition_ms": 1e3 * t_repart,
             "speedup": t_scratch / t_inc,
             "repartition_speedup": t_repart / t_inc}
        host.append(h)
        log(f"{name} {variant} (gs={cfg.gs} gpt={cfg.gpt} ont={cfg.ont} "
            f"src_win={cfg.src_win}): delta of {eb} edges -> "
            f"{st['incremental']}, dirty {st['dirty_fraction']:.4f} "
            f"(1% of the edges would dirty {frac_big:.4f}); host: "
            f"apply_delta {h['apply_delta_ms']:.1f}ms, fresh plan_for "
            f"{h['plan_for_ms']:.1f}ms ({h['speedup']:.1f}x), repartition "
            f"at the config {h['repartition_ms']:.1f}ms "
            f"({h['repartition_speedup']:.1f}x)")
        check(st["incremental"] == "patched",
              f"{name}: Plan.apply_delta took the {st['incremental']} path")
        check(plan2.epoch == plan.epoch + 1, f"{name}: epoch not bumped")
        for direction, part, perm, part_f, graph, vals in fresh:
            sp = DeviceSchedule(part, DEVICE, edge_perm=perm)
            sf = DeviceSchedule(part_f, DEVICE)
            n = sp.num_nodes
            visited = torch.repeat_interleave(sp.block_visited, sp.ont)[:n]
            check(torch.equal(visited, torch.repeat_interleave(
                sf.block_visited, sf.ont)[:n]),
                  f"{name} {direction}: patched and fresh schedules visit "
                  f"other node blocks")
            for d in widths:
                for dtype in dtypes:
                    case = KernelCase(sp, graph, vals, d, dtype, variant,
                                      cfg.dt, seed=d, device=DEVICE)
                    rec = dict(case.run(), graph=name, direction=direction,
                               schedule="patched")
                    KernelCase.holds(rec, f"{name} {variant} patched "
                                     f"{direction}")
                    case_f = KernelCase(sf, graph, vals, d, dtype, variant,
                                        cfg.dt, seed=d, device=DEVICE)
                    kp, kf = case.kernel()[:n, :d], case_f.kernel()[:n, :d]
                    mag = case.oracle(case.feat_p.double().abs(),
                                      sp.edge_val.double().abs())[:n, :d]
                    rec["fresh_err_scaled"] = float(
                        ((kp - kf).double().abs() / (1.0 + mag))[visited]
                        .max())
                    rec["fresh_ms"] = time_ms(case_f.kernel)
                    rec["fresh_device_ms"] = time_ms(case_f.kernel,
                                                     device_only=True)
                    rec["fresh_tiles"] = sf.num_tiles
                    records.append(rec)
                    log(f"  {direction} D={d} {rec['dtype']} "
                        f"({rec['tiles']} tiles, fresh {sf.num_tiles}): "
                        f"{KernelCase.summary(rec)}; vs fresh "
                        f"{rec['fresh_err_scaled']:.2e}, fresh device "
                        f"{rec['fresh_device_ms']:.4f}ms")
                    check(rec["fresh_err_scaled"] <= TOL,
                          f"{name} {direction}: patched vs fresh schedule "
                          f"{rec['fresh_err_scaled']:.2e} > {TOL}")
                    del case, case_f
            if direction == "bwd":
                # the autograd Function over the patched pair
                gen = torch.Generator(device=DEVICE).manual_seed(5)
                fwd = plan2.sched(DEVICE)
                feat = torch.randn((n, 16), generator=gen, device=DEVICE)
                cot = torch.randn((n, 16), generator=gen, device=DEVICE)
                grads = {}
                for backend in ("cuda", "torch"):
                    f = feat.clone().requires_grad_(True)
                    y = aggregate(f, fwd, dt=cfg.dt, backend=backend,
                                  variant=variant, sched_bwd=sp)
                    (y * cot).sum().backward()
                    grads[backend] = f.grad.double()
                mag_f = group_aggregate_ref(
                    torch.nn.functional.pad(cot.abs(), (0, 0, 0,
                                                        sp.padded_src_rows - n)),
                    sp.nbrs, sp.edge_val.abs(), sp.local_node,
                    sp.tile_node_block, sp.ont, sp.padded_out_rows,
                    acc_dtype=torch.float64)[:n]
                gerr = float(((grads["cuda"] - grads["torch"]).abs()
                              / (1 + mag_f)).max())
                h["autograd_feat_err_scaled"] = gerr
                log(f"  autograd on the patched pair, cuda vs torch: feat "
                    f"{gerr:.2e}")
                check(gerr <= TOL, f"{name}: autograd cuda vs torch on the "
                      f"patched pair {gerr:.2e} > {TOL}")
            del sp, sf
            torch.cuda.empty_cache()
        del plan2, fresh
    SHARED.pop("reddit_plan", None)
    detail["dynamic"] = {"host": host, "kernels": records}
    return records


DEVICE = "cuda"          # phases 5c, 6 and 7 build their inputs here
SCAN_SHAPES = [("reduced", (2, 64, 128, 8)), ("ragged", (3, 40, 20, 4)),
               ("layer-256", (1, 256, 8192, 16)),
               ("timed", (4, 2048, 8192, 16))]
SCAN_TIMED = "timed"


def scan_inputs(B, S, di, N, seed) -> list:
    """The operands of `tests/test_selective_scan.py:_inputs` (numpy,
    float32) on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, S, di)),
            rng.standard_normal((B, S, di)) * 0.5 - 1.0,
            rng.standard_normal((B, S, N)),
            rng.standard_normal((B, S, N)),
            np.log(rng.uniform(0.5, 4.0, (di, N))),
            rng.standard_normal(di) * 0.1,
            rng.standard_normal(di))
    return [torch.from_numpy(a.astype(np.float32)).to(DEVICE) for a in arrs]


def scan_bound(B, S, di, N) -> tuple:
    """``(bound_ms, bound_by, sfu_ms)`` of one scan call.  The bound:
    each input read once and y written once (f32), about 7 FLOP per (b,
    t, d, n).  ``sfu_ms`` is the N + 2 exp/log per (b, t, d) (N for exp(dt
    A), one exp and one log1p for softplus) over the special-function
    rate: the floor of a design that runs every exp/log on the SFUs, as
    this kernel does.  It is not the card's floor: a float32 exp also
    runs as a polynomial on the FMA pipes (128 lanes per SM against 16
    SFU results per clock), and with the exp/log split between both the
    compute stays under the bytes term at N = 16 as long as a polynomial
    costs fewer than about 21 FMA-pipe instructions."""
    from repro_torch.hw import H100_SXM
    bms, by = bound(4.0 * (3 * B * S * di + 2 * B * S * N + di * N + 2 * di),
                    7.0 * B * S * di * N)
    return bms, by, B * S * di * (N + 2) / H100_SXM.peak_sfu * 1e3


def _nerr(a, b) -> float:
    """``max|a-b| / (1 + max|b|)`` in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (1.0 + b.abs().max()))


# `--scan-variants`: names of the scan kernel's probe instantiations
# (`kProbes` in selective_scan.cu) phases 6 and 7 read beside the shipped one
SCAN_VARIANTS: tuple = ()


def _scan_lib(entry: str):
    from repro_torch.kernels import build
    lib = build.load("selective_scan")
    return lib, build.bind(lib, entry)


def scan_lanes_for(B, di, N) -> int:
    """Lanes per channel the shipped launch takes at this shape."""
    import ctypes
    _, fn = _scan_lib("repro_selective_scan_lanes")
    return fn(ctypes.c_int(B), ctypes.c_int(di), ctypes.c_int(N))


def scan_variant(name: str, args) -> "torch.Tensor":
    """The scan kernel's probe instantiation ``name`` on ``args``, through
    its probe entry (`repro_selective_scan_probe`; the wrapper never calls
    it, so it adds to no count)."""
    import ctypes

    import torch

    from repro_torch.kernels.build import raise_on
    lib, fn = _scan_lib("repro_selective_scan_probe")
    xc, b = args[0], args[2]
    B, S, di = xc.shape
    y = torch.empty_like(xc)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    i = ctypes.c_int
    code = fn(ctypes.c_char_p(name.encode()), *(ptr(a) for a in args), ptr(y),
              i(B), i(S), i(di), i(b.shape[-1]),
              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    raise_on(lib, code, f"selective_scan probe {name}")
    return y


def scan_checks(detail: dict) -> dict:
    """Phase 6: the scan kernel vs its plain version and the float64
    witness at the reduced, ragged and full-width layer shapes; times at
    each (per call and on the device alone), and each launch of
    `SCAN_VARIANTS` checked and timed beside it.  Returns the records keyed
    by shape name."""
    import torch

    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import selective_scan_ref

    out = {}
    for name, (B, S, di, N) in SCAN_SHAPES:
        t0 = time.time()
        args = scan_inputs(B, S, di, N, seed=B * 1000 + S)
        k = ss.selective_scan(*args)
        torch.cuda.synchronize()
        p = ss.selective_scan_plain(*args)
        w = selective_scan_ref(*args, acc_dtype=torch.float64)
        check(bool(torch.isfinite(k).all()) and k.shape == (B, S, di),
              f"scan {name}: bad kernel output {tuple(k.shape)}")
        bms, by, sfu_ms = scan_bound(B, S, di, N)
        rec = {"shape": name, "B": B, "S": S, "d_inner": di, "N": N,
               "lanes": scan_lanes_for(B, di, N),
               "max_abs_err": float((k - p).abs().max()),
               "err_plain": _nerr(k, p), "err_f64": _nerr(k, w),
               "plain_err_f64": _nerr(p, w),
               "bound_ms": bms, "bound_by": by, "sfu_ms": sfu_ms,
               "variants": []}
        for v in SCAN_VARIANTS:
            kv = scan_variant(v, args)
            probe = {"variant": v, "err_plain": _nerr(kv, p),
                     "err_f64": _nerr(kv, w),
                     "device_ms": time_ms(lambda: scan_variant(v, args),
                                          device_only=True)}
            rec["variants"].append(probe)
            log(f"scan {name} probe {v}: vs plain {probe['err_plain']:.2e} "
                f"vs f64 {probe['err_f64']:.2e} "
                f"device_ms={probe['device_ms']:.4f}")
            check(max(probe["err_plain"], probe["err_f64"]) <= TOL,
                  f"scan {name} probe {v}: {probe} beyond {TOL}")
            del kv
        del p, w
        full = di >= 8192
        rec["ms"] = time_ms(lambda: ss.selective_scan(*args))
        rec["device_ms"] = time_ms(lambda: ss.selective_scan(*args),
                                   device_only=True)
        rec["plain_ms"] = time_ms(lambda: ss.selective_scan_plain(*args),
                                  iters=3 if full else 20,
                                  warmup=1 if full else 3)
        rec["seconds"] = time.time() - t0
        log(f"scan {name} {(B, S, di, N)} ({rec['lanes']} lanes a channel): "
            f"kernel vs plain {rec['err_plain']:.2e} vs f64 "
            f"{rec['err_f64']:.2e} (plain {rec['plain_err_f64']:.2e}) "
            f"ms={rec['ms']:.4f} (device {rec['device_ms']:.4f}) "
            f"plain={rec['plain_ms']:.3f} bound={bms:.4f} ({by}; "
            f"exp/log on the SFUs {sfu_ms:.4f}) "
            f"({rec['seconds']:.1f}s)")
        check(rec["err_plain"] <= TOL, f"scan {name}: kernel vs plain "
              f"{rec['err_plain']:.3e} > {TOL}")
        check(rec["err_f64"] <= TOL, f"scan {name}: kernel vs float64 "
              f"{rec['err_f64']:.3e} > {TOL}")
        out[name] = rec
        del args, k
        torch.cuda.empty_cache()
    detail["scan"] = list(out.values())
    return out


LM_BATCH, LM_SEQ, LM_WARMUP, LM_ITERS = 4, 2048, 1, 5
LM_CMP_SEQ, LM_DECODE_SEQ, LM_F32_LAYERS = 256, 64, 4
LM_F32_SEEDS = (1, 2, 3, 4, 5)     # phase 7c's weight seeds, checked first
F32_DECODE_TOL = 1e-4
SERVE_ARGV = ["--arch", "falcon-mamba-7b", "--full", "--batch", "4",
              "--prompt-len", "16", "--gen-len", "32"]


def _all_counts() -> dict:
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.kernels import selective_scan as ss
    return {**ga.launches, **ss.launches}


def _reset_counts() -> None:
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.kernels import selective_scan as ss
    ga.reset_launches()
    ss.reset_launches()


def positions(B: int, S: int) -> "torch.Tensor":
    """Prefill positions 0..S-1 for every row, (B, S) on the card."""
    import torch
    return torch.arange(S, device=DEVICE).expand(B, S)


def _kind(name: str) -> str:
    """A device op's kind by its kernel name: f32 GEMM, other GEMM,
    elementwise, reduction or other."""
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "gemm_f32" if ("sgemm" in low or "f32f32" in low) else "gemm"
    if "elementwise" in low:
        return "elementwise"
    return "reduce" if "reduce" in low else "other"


def _profile(fn) -> dict:
    """One call of ``fn`` under `torch.profiler`: device time by kernel
    name (top 12) and by kind (`_kind`), and the device-busy share of the
    host-clock wall time.  The sums are taken over the profiler's raw
    device events (its per-event post-processing takes minutes for the
    hundreds of thousands of launches of a training step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acc, queue_full = {}, 0.0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue                    # host ops; their kernels are below
        ms = ev.duration_ns() / 1e6
        if ev.name().startswith("Command Buffer Full"):
            queue_full += ms            # the host waited on a full queue
        elif ms > 0:
            tot, n = acc.get(ev.name(), (0.0, 0))
            acc[ev.name()] = (tot + ms, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in acc.items()),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    kinds: dict = {}
    for name, ms, _ in rows:
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if rows else None,
            "queue_full_ms": queue_full, "by_kind_ms": kinds,
            "top": [{"name": n[:80], "ms": ms, "count": c}
                    for n, ms, c in rows[:12]]}


def lm_serving(detail: dict) -> dict:
    """Phase 7: Falcon-Mamba-7B at full width and depth (64 layers, bf16,
    random weights): prefill through the scan kernel, the cuda vs torch
    backends, prefill vs decode in float32 at 4 layers, the serve CLI."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs.falcon_mamba_7b import full
    from repro_torch.device import set_matmul_precision
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.launch import serve
    from repro_torch.models.lm import (LMModel, make_decode_step,
                                       make_prefill_step)
    from repro_torch.nn import mamba as mamba_mod
    from repro_torch.nn.transformer import init_lm_cache

    rec = {}
    cfg = full()
    t0 = time.time()
    model = LMModel.create(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    rec["n_params"] = model.n_params
    rec["init_s"] = time.time() - t0
    log(f"lm: {cfg.name} {cfg.n_layers} layers, {model.n_params:,} params "
        f"in {cfg.dtype}, init {rec['init_s']:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    check(model.n_params == 7_272_665_088,
          f"full() holds {model.n_params} parameters, not 7,272,665,088")

    # (a) prefill, the main path
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ)),
                             device=DEVICE)
    pos = positions(LM_BATCH, LM_SEQ)
    prefill = make_prefill_step(cfg, backend="cuda")
    torch.cuda.reset_peak_memory_stats()
    times = []
    _reset_counts()
    for i in range(LM_WARMUP + LM_ITERS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, _ = prefill(model.params, tokens, pos)
        torch.cuda.synchronize()
        if i >= LM_WARMUP:
            times.append((time.perf_counter() - t1) * 1e3)
    counts = _all_counts()
    runs = LM_WARMUP + LM_ITERS
    want = {k: 0 for k in counts}
    want[ss.KERNEL] = runs * cfg.n_layers
    check(counts == want, f"prefill launch counts {counts} != {want}")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (LM_BATCH, cfg.vocab),
          f"prefill logits bad: shape {tuple(logits.shape)}")
    ms = statistics.median(times)
    rec.update(prefill_ms=ms, prefill_ms_all=times,
               prompt_tok_per_s=LM_BATCH * LM_SEQ / (ms / 1e3),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts[ss.KERNEL], prefills=runs,
               launches_per_prefill=counts[ss.KERNEL] / runs,
               plain_calls=counts[ss.PLAIN])
    log(f"lm prefill B={LM_BATCH} S={LM_SEQ}: {ms:.1f} ms (median of "
        f"{LM_ITERS}; {', '.join(f'{t:.1f}' for t in times)}), "
        f"{rec['prompt_tok_per_s']:.0f} prompt tok/s, peak "
        f"{rec['peak_gb']:.2f} GB, selective_scan launches "
        f"{counts[ss.KERNEL]} over {runs} prefills, plain {counts[ss.PLAIN]}")
    # one prefill and one decode step (B 4, bf16) under the profiler
    cache = init_lm_cache(cfg, LM_BATCH, device=DEVICE)
    decode = make_decode_step(cfg)
    decode(model.params, cache, tokens[:, 0], 0)
    for what, fn in (
            ("prefill", lambda: prefill(model.params, tokens, pos)),
            ("decode step", lambda: decode(model.params, cache,
                                           tokens[:, 1], 1))):
        prof = _profile(fn)
        rec[f"profile_{what.split()[0]}"] = prof
        log(f"lm {what} profile: wall {prof['wall_ms']:.2f} ms, device "
            f"{prof['device_ms']:.2f} ms, idle share "
            f"{prof['idle_share']}, launch queue full "
            f"{prof['queue_full_ms']:.1f} ms; top: "
            + "; ".join(f"{r['name'][:40]} {r['ms']:.2f}ms x{r['count']}"
                        for r in prof["top"][:6]))
    del logits, tokens, cache

    # (b) cuda vs torch at full depth.  The check holds the scan on the
    # model's own operands: during one cuda-backend prefill (the model's
    # own layer loop), every layer's call of the scan wrapper also runs the
    # plain version and the float64 witness on the same operands, and the
    # float32 outputs y (before the gate and the bf16 out_proj) must agree
    # within TOL, as in phase 6.  The free-running last-token logits are
    # read beside a control that runs no kernel (the plain fused path vs
    # the chunked path): the random-weight model amplifies float32
    # rounding through its 64 layers, so the control parts as far.
    t0 = time.time()
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (LM_BATCH, LM_CMP_SEQ)),
                             device=DEVICE)
    pos = positions(LM_BATCH, LM_CMP_SEQ)
    layer_errs, variant_errs = [], {v: [] for v in SCAN_VARIANTS}

    def probe(*args):
        y = ss.selective_scan(*args)
        plain = ss.selective_scan_plain(*args)
        witness = selective_scan_ref(*args, acc_dtype=torch.float64)
        layer_errs.append((_nerr(y, plain), _nerr(y, witness)))
        for v in SCAN_VARIANTS:          # `--scan-variants`, read beside
            yv = scan_variant(v, args)
            variant_errs[v].append(max(_nerr(yv, plain), _nerr(yv, witness)))
        return y

    _reset_counts()
    with mock.patch.object(mamba_mod, "selective_scan", probe):
        a, _ = make_prefill_step(cfg, backend="cuda")(model.params, tokens,
                                                      pos)
    counts = _all_counts()
    check(counts[ss.KERNEL] == cfg.n_layers
          and counts[ss.PLAIN] == cfg.n_layers
          and len(layer_errs) == cfg.n_layers,
          f"backend comparison counts {counts}, {len(layer_errs)} layers")
    b, _ = make_prefill_step(cfg, backend="torch")(model.params, tokens, pos)
    chunked = dataclasses.replace(cfg, mamba=dataclasses.replace(
        cfg.mamba, fused_scan="off"))
    c, _ = make_prefill_step(chunked, backend="torch")(model.params, tokens,
                                                       pos)
    plain_errs = [e[0] for e in layer_errs]
    f64_errs = [e[1] for e in layer_errs]
    rec.update(layer_scan_errs=plain_errs, layer_scan_errs_f64=f64_errs,
               backend_err=max(plain_errs), backend_err_f64=max(f64_errs),
               logits_err=_nerr(a, b), control_err=_nerr(c, b))
    log(f"lm cuda vs torch, B={LM_BATCH} S={LM_CMP_SEQ}: every layer's scan "
        f"output, kernel vs plain max {max(plain_errs):.3e}, vs float64 max "
        f"{max(f64_errs):.3e} (layers {plain_errs.index(max(plain_errs))}, "
        f"{f64_errs.index(max(f64_errs))}); free-running last-token logits "
        f"{rec['logits_err']:.3e} (max|b| {float(b.abs().max()):.3f}), "
        f"control without the kernel (fused plain vs chunked) "
        f"{rec['control_err']:.3e} ({time.time() - t0:.1f}s)")
    rec["variant_layer_scan_errs"] = {
        k: max(v) for k, v in variant_errs.items()}
    for v, err in rec["variant_layer_scan_errs"].items():
        log(f"lm scan variant {v}: every layer's output vs plain and "
            f"float64, max {err:.3e}" + (" (over the limit)" if err > TOL
                                         else ""))
    check(max(plain_errs) <= TOL, f"cuda vs torch scan output "
          f"{max(plain_errs):.3e} > {TOL}")
    check(max(f64_errs) <= TOL, f"cuda scan output vs float64 "
          f"{max(f64_errs):.3e} > {TOL}")
    del model, a, b, c, tokens, prefill
    torch.cuda.empty_cache()

    # (c) prefill (kernel) vs decode (recurrence), float32, 4 layers, at
    # each weight seed of LM_F32_SEEDS; the plain version's prefill read
    # beside it, and at the first seed a control: a prefill whose float32
    # products ran in TF32 against the float32 decode (a reading: what the
    # limit must catch)
    t0 = time.time()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                n_layers=LM_F32_LAYERS)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (LM_BATCH, LM_DECODE_SEQ)),
                             device=DEVICE)
    pos = positions(LM_BATCH, LM_DECODE_SEQ)

    def decoded(params):
        cache = init_lm_cache(cfg32, LM_BATCH, dtype=torch.float32,
                              device=DEVICE)
        decode = make_decode_step(cfg32)
        for t in range(LM_DECODE_SEQ):
            got, cache = decode(params, cache, tokens[:, t], t)
        return got

    def prefilled(params, backend="cuda", tf32=False):
        step = make_prefill_step(cfg32, backend=backend)  # sets float32
        if not tf32:
            return step(params, tokens, pos)[0]
        torch.set_float32_matmul_precision("high")       # TF32 products
        try:
            return step(params, tokens, pos)[0]
        finally:
            set_matmul_precision()

    errs, plain_errs = {}, {}
    variant_errs = {v: {} for v in SCAN_VARIANTS}
    for seed in LM_F32_SEEDS:
        m32 = LMModel.create(cfg32, seed=seed, device=DEVICE)
        got = decoded(m32.params)
        errs[seed] = _nerr(got, prefilled(m32.params))
        plain_errs[seed] = _nerr(got, prefilled(m32.params, "torch"))
        if seed == LM_F32_SEEDS[0]:
            tf32_err = _nerr(got, prefilled(m32.params, tf32=True))
        for v in SCAN_VARIANTS:            # the prefill's scans through it
            with mock.patch.object(mamba_mod, "selective_scan",
                                   lambda *a: scan_variant(v, a)):
                variant_errs[v][seed] = _nerr(got, prefilled(m32.params))
        del m32, got
    rec["variant_prefill_vs_decode_errs"] = variant_errs
    for v, by_seed in variant_errs.items():
        log(f"lm prefill vs decode through scan variant {v}: "
            + ", ".join(f"{k}: {e:.3e}" for k, e in by_seed.items())
            + (" (over the limit)" if max(by_seed.values()) > F32_DECODE_TOL
               else ""))
    rec.update(prefill_vs_decode_err=max(errs.values()),
               prefill_vs_decode_errs=errs,
               plain_prefill_vs_decode_errs=plain_errs,
               tf32_prefill_vs_decode_err=tf32_err,
               f32_params=LMModel.create(cfg32, device="meta").n_params)
    log(f"lm prefill vs decode, float32, {LM_F32_LAYERS} layers "
        f"({rec['f32_params']:,} params), {LM_DECODE_SEQ} tokens, by weight "
        f"seed: " + ", ".join(f"{k}: {v:.3e} (plain {plain_errs[k]:.3e})"
                              for k, v in errs.items())
        + f"; TF32 prefill at seed {LM_F32_SEEDS[0]}: {tf32_err:.3e} "
        f"({time.time() - t0:.1f}s)")
    for seed, err in errs.items():
        check(err <= F32_DECODE_TOL, f"prefill vs decode at seed {seed} "
              f"{err:.3e} > {F32_DECODE_TOL}")
    torch.cuda.empty_cache()

    # (d) the serve CLI, decoding from step 0 at full depth
    t0 = time.time()
    res = serve.run(SERVE_ARGV)
    toks = res["tokens"]
    check(toks.shape == (4, 32) and bool((toks >= 0).all())
          and bool((toks < cfg.vocab).all()), f"serve tokens {toks.shape}")
    rec.update(decode_tok_per_s=res["tok_per_s"],
               decode_s=res["seconds"], serve_s=time.time() - t0)
    log(f"lm serve CLI: {res['tok_per_s']:.1f} tok/s ({res['seconds']:.2f}s "
        f"for {res['steps']} steps; {rec['serve_s']:.1f}s with init)")
    torch.cuda.empty_cache()
    detail["lm"] = rec
    return rec


# phase 9: the attention + MoE LM stack, Jamba's hybrid prefill on the scan
# kernel at full width, gemma2-2b through the serve CLI
HYBRID_LAYERS = 8                    # one Jamba period: 7 Mamba slots, 1 attn
HYBRID_PARAMS = 13_295_235_072       # the JAX package's count at that depth
HYBRID_SEEDS = (1, 2, 3)             # 9c's weight seeds
HYBRID_F32_BATCH = 2
GEMMA_SERVE_ARGV = ["--arch", "gemma2-2b", "--full", "--batch", "4",
                    "--prompt-len", "16", "--gen-len", "32"]
GEMMA_F32_WINDOW = 16                # 9d: the ring of the local layers wraps


def _decode_all(cfg, params, inputs, max_seq):
    """Last-token logits of ``inputs.shape[1]`` decode steps from step 0
    (float32 cache)."""
    import torch

    from repro_torch.models.lm import make_decode_step
    from repro_torch.nn.transformer import init_lm_cache
    cache = init_lm_cache(cfg, inputs.shape[0], max_seq=max_seq,
                          dtype=torch.float32, device=DEVICE)
    decode = make_decode_step(cfg)
    for t in range(inputs.shape[1]):
        got, cache = decode(params, cache, inputs[:, t], t)
    return got


def _layer_errs(cfg, params, inputs, pos) -> list:
    """Each layer held alone: its prefill forward over the sequence
    against its decode step run from step 0 over the same input hidden
    states (float32 caches), ``max|a-b|/(1+max|b|)`` over every position.
    The input of layer l is the prefill's output of layer l-1."""
    import torch

    from repro_torch.nn import transformer as tf
    from repro_torch.nn.attention import init_cache
    from repro_torch.nn.mamba import init_mamba_state

    B, S = inputs.shape[:2]
    errs = []
    with torch.no_grad():
        x = tf._embed_in(cfg, params, inputs, pos)
        for slots in params["blocks"]:
            for spec, bp in zip(cfg.period, slots):
                want, _, _ = tf._slot_forward(cfg, spec, bp, x, pos,
                                              backend="cuda")
                cache = (init_cache(B, cfg.attn_params(spec), S,
                                    torch.float32, device=DEVICE)
                         if spec.kind == "attn" else
                         init_mamba_state(B, cfg.d_model, cfg.mamba,
                                          torch.float32, device=DEVICE))
                got = torch.cat([tf._slot_decode(
                    cfg, spec, bp, cache, x[:, t:t + 1], t,
                    pos[:, t:t + 1]) for t in range(S)], dim=1)
                errs.append(_nerr(got, want))
                x = want
    return errs


def lm_hybrid(detail: dict) -> dict:
    """Phase 9: Jamba-v0.1 at full width, one period (bf16, random
    weights): prefill through the scan kernel, cuda vs torch, prefill vs
    decode in float32; gemma2-2b through the serve CLI and prefill vs
    decode in float32 with a wrapping ring."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs import gemma2_2b, jamba_v0_1_52b
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.launch import serve
    from repro_torch.models.lm import (LMModel, make_decode_step,
                                       make_prefill_step)
    from repro_torch.nn import mamba as mamba_mod
    from repro_torch.nn import transformer as tf_mod
    from repro_torch.nn.transformer import init_lm_cache

    rec = {}
    cfg = dataclasses.replace(jamba_v0_1_52b.full(), n_layers=HYBRID_LAYERS)
    scans = sum(s.kind == "mamba" for s in cfg.period) * cfg.repeats
    attn_slot = [s.kind for s in cfg.period].index("attn")
    t0 = time.time()
    model = LMModel.create(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    rec.update(n_params=model.n_params, init_s=time.time() - t0)
    log(f"lm-hybrid: {cfg.name} {cfg.n_layers} layers (one period), "
        f"{model.n_params:,} params in {cfg.dtype}, init "
        f"{rec['init_s']:.1f}s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")
    check(model.n_params == HYBRID_PARAMS, f"one Jamba period holds "
          f"{model.n_params} parameters, not {HYBRID_PARAMS:,}")

    # (a) prefill, the main path; the warm-up run also records every MoE
    # layer's dropped share
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ)),
                             device=DEVICE)
    pos = positions(LM_BATCH, LM_SEQ)
    prefill = make_prefill_step(cfg, backend="cuda")
    drops, moe_apply = [], tf_mod.moe_apply

    def moe_probe(*args, **kw):
        out, aux, dropped = moe_apply(*args, **kw)
        drops.append(dropped)
        return out, aux, dropped

    torch.cuda.reset_peak_memory_stats()
    times = []
    _reset_counts()
    for i in range(LM_WARMUP + LM_ITERS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i < LM_WARMUP:
            with mock.patch.object(tf_mod, "moe_apply", moe_probe):
                logits, kvs = prefill(model.params, tokens, pos)
        else:
            logits, kvs = prefill(model.params, tokens, pos)
        torch.cuda.synchronize()
        if i >= LM_WARMUP:
            times.append((time.perf_counter() - t1) * 1e3)
    counts = _all_counts()
    runs = LM_WARMUP + LM_ITERS
    want = {k: 0 for k in counts}
    want[ss.KERNEL] = runs * scans
    check(counts == want, f"hybrid prefill launch counts {counts} != {want}")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (LM_BATCH, cfg.vocab),
          f"hybrid prefill logits bad: shape {tuple(logits.shape)}")
    kv_shape = (cfg.repeats, LM_BATCH, LM_SEQ, cfg.n_kv, cfg.head_dim)
    check(all((kv is None) == (s.kind == "mamba")
              for s, kv in zip(cfg.period, kvs))
          and all(tuple(t.shape) == kv_shape for t in kvs[attn_slot]),
          f"hybrid kvs: attention slot {attn_slot} "
          f"{[tuple(t.shape) for t in kvs[attn_slot]]} != {kv_shape}")
    ms = statistics.median(times)
    rec.update(prefill_ms=ms, prefill_ms_all=times,
               prompt_tok_per_s=LM_BATCH * LM_SEQ / (ms / 1e3),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts[ss.KERNEL], prefills=runs,
               launches_per_prefill=counts[ss.KERNEL] / runs,
               plain_calls=counts[ss.PLAIN],
               moe_dropped=[float(d) for d in drops])
    log(f"lm-hybrid prefill B={LM_BATCH} S={LM_SEQ}: {ms:.1f} ms (median of "
        f"{LM_ITERS}; {', '.join(f'{t:.1f}' for t in times)}), "
        f"{rec['prompt_tok_per_s']:.0f} prompt tok/s, peak "
        f"{rec['peak_gb']:.2f} GB, selective_scan launches "
        f"{counts[ss.KERNEL]} over {runs} prefills, plain "
        f"{counts[ss.PLAIN]}; MoE dropped share by layer "
        + ", ".join(f"{d:.4f}" for d in rec["moe_dropped"]))
    cache = init_lm_cache(cfg, LM_BATCH, max_seq=LM_SEQ, device=DEVICE)
    decode = make_decode_step(cfg)
    decode(model.params, cache, tokens[:, 0], 0)
    for what, fn in (
            ("prefill", lambda: prefill(model.params, tokens, pos)),
            ("decode step", lambda: decode(model.params, cache,
                                           tokens[:, 1], 1))):
        prof = _profile(fn)
        rec[f"profile_{what.split()[0]}"] = prof
        log(f"lm-hybrid {what} profile: wall {prof['wall_ms']:.2f} ms, "
            f"device {prof['device_ms']:.2f} ms, idle share "
            f"{prof['idle_share']}, launch queue full "
            f"{prof['queue_full_ms']:.1f} ms; top: "
            + "; ".join(f"{r['name'][:40]} {r['ms']:.2f}ms x{r['count']}"
                        for r in prof["top"][:8]))
    del logits, kvs, cache, tokens

    # (b) cuda vs torch: inside one cuda-backend prefill every Mamba
    # layer's scan operands also go through the plain version and the
    # float64 witness (as 7b); the free-running logits of both backends
    # are read beside
    t0 = time.time()
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (LM_BATCH, LM_CMP_SEQ)),
                             device=DEVICE)
    pos = positions(LM_BATCH, LM_CMP_SEQ)
    layer_errs = []

    def probe(*args):
        y = ss.selective_scan(*args)
        layer_errs.append((
            _nerr(y, ss.selective_scan_plain(*args)),
            _nerr(y, selective_scan_ref(*args, acc_dtype=torch.float64))))
        return y

    _reset_counts()
    with mock.patch.object(mamba_mod, "selective_scan", probe):
        a, _ = make_prefill_step(cfg, backend="cuda")(model.params, tokens,
                                                      pos)
    counts = _all_counts()
    check(counts[ss.KERNEL] == scans and counts[ss.PLAIN] == scans
          and len(layer_errs) == scans,
          f"hybrid backend comparison counts {counts}, {len(layer_errs)} "
          f"layers")
    b, _ = make_prefill_step(cfg, backend="torch")(model.params, tokens, pos)
    plain_errs = [e[0] for e in layer_errs]
    f64_errs = [e[1] for e in layer_errs]
    rec.update(layer_scan_errs=plain_errs, layer_scan_errs_f64=f64_errs,
               backend_err=max(plain_errs), backend_err_f64=max(f64_errs),
               logits_err=_nerr(a, b))
    log(f"lm-hybrid cuda vs torch, B={LM_BATCH} S={LM_CMP_SEQ}: every Mamba "
        f"layer's scan output, kernel vs plain max {max(plain_errs):.3e}, vs "
        f"float64 max {max(f64_errs):.3e}; free-running last-token logits "
        f"{rec['logits_err']:.3e} (max|b| {float(b.abs().max()):.3f}) "
        f"({time.time() - t0:.1f}s)")
    check(max(plain_errs) <= TOL, f"hybrid cuda vs torch scan output "
          f"{max(plain_errs):.3e} > {TOL}")
    check(max(f64_errs) <= TOL, f"hybrid cuda scan output vs float64 "
          f"{max(f64_errs):.3e} > {TOL}")
    del model, a, b, tokens, prefill
    torch.cuda.empty_cache()

    # (c) float32, prefill (kernel) vs decode from step 0, at a capacity
    # factor of n_experts / topk so that neither drops a token (prefill
    # routes B*S tokens at once, decode B: at the shipped 1.25 prefill
    # drops choices decode keeps).  The check holds each layer alone (its
    # prefill forward vs its decode steps on the same input): the random
    # weights' fan-in-2 FFNs and experts amplify float32 rounding through
    # the period, so the whole model's last-token logits part by about
    # 1e-4 on the plain version as on the kernel (both read beside)
    t0 = time.time()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                moe=dataclasses.replace(
                                    cfg.moe, capacity_factor=cfg.moe.n_experts
                                    / cfg.moe.topk))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (HYBRID_F32_BATCH,
                                                         LM_DECODE_SEQ)),
                             device=DEVICE)
    pos = positions(HYBRID_F32_BATCH, LM_DECODE_SEQ)
    errs, plain_errs, layer_worst = {}, {}, {}
    for seed in HYBRID_SEEDS:
        m32 = LMModel.create(cfg32, seed=seed, device=DEVICE)
        got = _decode_all(cfg32, m32.params, tokens, LM_DECODE_SEQ)
        errs[seed] = _nerr(got, make_prefill_step(cfg32, backend="cuda")(
            m32.params, tokens, pos)[0])
        plain_errs[seed] = _nerr(got, make_prefill_step(
            cfg32, backend="torch")(m32.params, tokens, pos)[0])
        layer_worst[seed] = max(_layer_errs(cfg32, m32.params, tokens, pos))
        del m32, got
        torch.cuda.empty_cache()
    rec.update(prefill_vs_decode_errs=errs,
               plain_prefill_vs_decode_errs=plain_errs,
               layer_prefill_vs_decode_errs=layer_worst,
               prefill_vs_decode_err=max(layer_worst.values()))
    log(f"lm-hybrid prefill vs decode, float32, B={HYBRID_F32_BATCH}, "
        f"{LM_DECODE_SEQ} tokens, capacity factor "
        f"{cfg32.moe.capacity_factor}, by weight seed: "
        + ", ".join(f"{k}: worst layer alone {layer_worst[k]:.3e}; whole "
                    f"model {v:.3e} (plain {plain_errs[k]:.3e})"
                    for k, v in errs.items())
        + f" ({time.time() - t0:.1f}s)")
    for seed, err in layer_worst.items():
        check(err <= F32_DECODE_TOL, f"hybrid prefill vs decode, a layer "
              f"alone at seed {seed}: {err:.3e} > {F32_DECODE_TOL}")

    # (d) gemma2-2b, whole, through the serve CLI; then in float32 with its
    # local window cut to 16, prefill vs decode from step 0
    t0 = time.time()
    res = serve.run(GEMMA_SERVE_ARGV)
    g_cfg = res["cfg"]
    toks = res["tokens"]
    check(toks.shape == (4, 32) and bool((toks >= 0).all())
          and bool((toks < g_cfg.vocab).all()), f"gemma serve tokens "
          f"{toks.shape}")
    rec.update(gemma_decode_tok_per_s=res["tok_per_s"],
               gemma_decode_s=res["seconds"], gemma_serve_s=time.time() - t0)
    log(f"lm-hybrid gemma2-2b serve CLI ({g_cfg.n_layers} layers, "
        f"{g_cfg.dtype}): {res['tok_per_s']:.1f} tok/s "
        f"({res['seconds']:.2f}s for {res['steps']} steps; "
        f"{rec['gemma_serve_s']:.1f}s with init)")
    torch.cuda.empty_cache()
    t0 = time.time()
    g32 = dataclasses.replace(gemma2_2b.full(), dtype=torch.float32,
                              period=tuple(dataclasses.replace(
                                  s, window=GEMMA_F32_WINDOW if s.window
                                  else None) for s in gemma2_2b.full().period))
    m32 = LMModel.create(g32, seed=1, device=DEVICE)
    tokens = torch.as_tensor(rng.integers(0, g32.vocab, (HYBRID_F32_BATCH,
                                                         LM_DECODE_SEQ)),
                             device=DEVICE)
    pos = positions(HYBRID_F32_BATCH, LM_DECODE_SEQ)
    got = _decode_all(g32, m32.params, tokens, LM_DECODE_SEQ)
    err = _nerr(got, make_prefill_step(g32)(m32.params, tokens, pos)[0])
    layer_err = max(_layer_errs(g32, m32.params, tokens, pos))
    rec.update(gemma_prefill_vs_decode_err=err,
               gemma_layer_prefill_vs_decode_err=layer_err,
               gemma_f32_params=m32.n_params)
    log(f"lm-hybrid gemma2-2b float32 ({m32.n_params:,} params, local "
        f"window {GEMMA_F32_WINDOW}), prefill vs decode over {LM_DECODE_SEQ} "
        f"tokens: {err:.3e} (worst layer alone {layer_err:.3e}) "
        f"({time.time() - t0:.1f}s)")
    check(err <= F32_DECODE_TOL, f"gemma2-2b prefill vs decode {err:.3e} > "
          f"{F32_DECODE_TOL}")
    del m32, got
    torch.cuda.empty_cache()
    detail["lm_hybrid"] = rec
    return rec


# phase 8: the profiling tier and the measured tuner on the kernels
PROFILE_ITERS, PROFILE_WARMUP = 10, 3
RACE_ITERS, RACE_WARMUP = 10, 2
RACE_DIMS = (16, 500)
RACE_MARGIN = 0.05           # select_variant_measured's default margin
ATTRIBUTION_LIMIT = 0.5      # the reference's own limit
HARNESS_AGREEMENT = 1.5      # measure's device p50 vs time_ms, either way
PROFILE_BACKEND = "cuda"     # the backend every part of phase 8 runs
PROFILE_SERVE = SERVE_COMMON + ["--arch", "gcn", "--hidden-dim", "16",
                                "--variant", "folded"]


def run_stats(p) -> dict:
    """A partition's tiles, runs, and the live slots and tiles of its
    longest run (by live slots): what `KernelModel` prices."""
    import numpy as np

    from repro_torch.kernels.ops import run_bounds
    live = (int(p.edge_slot.max()) // p.gpt + 1) if p.num_edges else 0
    bounds = run_bounds(np.asarray(p.tile_node_block[:live]))
    tile_of_edge = np.asarray(p.edge_slot, np.int64) // p.gpt
    run_of_edge = np.searchsorted(bounds, tile_of_edge, side="right") - 1
    per_run = np.bincount(run_of_edge, minlength=len(bounds) - 1)
    h = int(per_run.argmax()) if len(per_run) else 0
    return {"tiles": int(p.num_tiles), "live_tiles": live,
            "runs": len(bounds) - 1, "edges": int(p.num_edges),
            "hub_live_slots": int(per_run[h]) if len(per_run) else 0,
            "hub_tiles": int(bounds[h + 1] - bounds[h]) if len(per_run)
            else 0}


def _model_row(plan, part, d, variant=None) -> dict:
    import dataclasses

    from repro_torch.core.extractor import extract_graph_props
    from repro_torch.core.model import KernelModel
    cfg = plan.config if variant is None else dataclasses.replace(
        plan.config, variant=variant)
    props = plan.graph_props or extract_graph_props(
        plan.graph, detect_communities=False)
    return KernelModel().terms(props, d, cfg, tiles=part.num_tiles)


def _point(what: str, props, d: int, cfg, tiles: int, m) -> dict:
    """One measured point in the form `tools/fit_kernel_costs.py` reads,
    with the shipped model's device time beside it."""
    from repro_torch.core.model import KernelModel
    return {"what": what, "variant": cfg.variant, "D": d,
            "config": list(cfg.astuple()), "feat_dtype": cfg.feat_dtype,
            "tiles": int(tiles), "dev_s": m.device_p50, "wall_s": m.p50,
            "model_dev_s": KernelModel().terms(props, d, cfg,
                                               tiles=tiles)["t_device"],
            "props": {"num_nodes": props.num_nodes,
                      "num_edges": props.num_edges,
                      "avg_degree": props.avg_degree,
                      "max_degree": props.max_degree}}


def _calls(m, iters: int) -> int:
    """Calls `measure` made for ``m``: warm-up, wall samples and, on the
    card, as many device-only samples (checked here)."""
    check(m.count == iters and len(m.device_samples) == (
        iters if DEVICE == "cuda" else 0),
          f"measure took {m.count} wall and {len(m.device_samples)} device "
          f"samples, expected {iters} each")
    return m.warmup + m.count + len(m.device_samples)


def _check_counts(counts: dict, want: dict, what: str) -> None:
    """Every count in ``counts`` equals ``want``'s (missing keys: 0)."""
    for k, v in counts.items():
        check(v == want.get(k, 0), f"{what}: {k} launched {v} times, "
              f"expected {want.get(k, 0)} (all counts {counts})")


def _trace_check(path: str, span: str, min_threads: int) -> dict:
    """A written Chrome trace parses and holds complete events whose names
    include ``span`` and a ``thread_name`` event for every thread that
    recorded one."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    named = {e["tid"] for e in evs if e.get("name") == "thread_name"}
    tids = {e["tid"] for e in spans}
    check(any(span in e["name"].split("/") for e in spans),
          f"{path}: no '{span}' span among "
          f"{sorted({e['name'] for e in spans})}")
    check(tids <= named, f"{path}: threads {sorted(tids - named)} have no "
          f"thread_name event")
    check(len(tids) >= min_threads, f"{path}: {len(tids)} thread tracks, "
          f"expected at least {min_threads}")
    check(bool(doc.get("otherData", {}).get("git_sha")),
          f"{path}: no run context in otherData")
    return {"events": len(spans), "threads": len(tids),
            "names": sorted({e["name"] for e in spans})}


def profiling(detail: dict) -> dict:
    """Phase 8: `profile_plan`, `select_variant_measured`, `measured_tune`,
    serving through a `PlanCache(measure_variants=True)` and the drivers'
    ``--trace-out``, all on the hand-written kernels; the launch counts are
    zeroed just before each part and read just after it."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.core import tuner as tuner_mod
    from repro_torch.core.advisor import plan_for
    import dataclasses

    from repro_torch.core.extractor import extract_graph_props
    from repro_torch.core.model import KernelModel, predict_tiles
    from repro_torch.core.tuner import measured_tune, select_variant_measured
    from repro_torch.graphs.csr import random_power_law
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.launch import serve_gnn, train
    from repro_torch.models.gnn import gcn_edge_values
    from repro_torch.obs import (MetricsRegistry, lint_prometheus,
                                 profile_plan, to_prometheus_text)
    from repro_torch.obs import profile as profile_mod
    from repro_torch.serving import PlanCache

    out = {"launches": {}}
    reg = MetricsRegistry()

    def tally():
        for k, v in ga.launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    # A. profile_plan: pubmed train-ready GCN plans (f32, bf16, folded) and
    # phase 2's full-reddit gather plan (D 64, f32)
    t0 = time.time()
    pubmed, vals_p = gcn_edge_values(random_power_law(19717, 4.5, seed=0))
    if "reddit" in SHARED:
        _, reddit, vals_r = SHARED["reddit"]
    else:
        reddit, vals_r = gcn_edge_values(make_dataset("reddit",
                                                      max_dim=1)[0])
        SHARED["reddit"] = (None, reddit, vals_r)
    plan_r = SHARED.get("reddit_plan") or plan_for(
        reddit, arch="gcn", in_dim=64, hidden_dim=64, edge_vals=vals_r,
        tune_iters=4, variant="direct")
    SHARED["reddit_plan"] = plan_r
    cases = [(f"pubmed-{dt}", plan_for(
        pubmed, arch="gcn", in_dim=16, hidden_dim=16, edge_vals=vals_p,
        tune_iters=4, variant="folded", with_backward=True, feat_dtype=dt),
        16) for dt in ("float32", "bfloat16")] + [("reddit-float32", plan_r,
                                                   64)]
    log(f"profile: plans ready ({time.time() - t0:.1f}s)")
    rows, points = [], []
    for name, plan, d in cases:
        cfg = plan.config
        kname = ga.KERNEL_OF_VARIANT[cfg.variant]
        ga.reset_launches()
        rep = profile_plan(plan, dim=d, backend=PROFILE_BACKEND, device=DEVICE,
                           iters=PROFILE_ITERS, warmup=PROFILE_WARMUP,
                           registry=reg, label=f"{name}/")
        counts = dict(ga.launches)
        tally()
        # each row's calls, and the total's: every schedule once a call
        n_sched = len(rep.schedules)
        _check_counts(counts, {kname: sum(
            _calls(s.measured, PROFILE_ITERS) for s in rep.schedules)
            + n_sched * _calls(rep.total, PROFILE_ITERS)},
                      f"profile {name}")
        err = rep.attribution_error()
        check(err <= ATTRIBUTION_LIMIT, f"profile {name}: attribution error "
              f"{err:.3f} > {ATTRIBUTION_LIMIT}")
        # the same executor under the other harness (time_ms, device only)
        ex = plan.executor(PROFILE_BACKEND, DEVICE)
        feat = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (plan.graph.num_nodes, d)).astype(np.float32)).to(
            DEVICE, getattr(torch, cfg.feat_dtype))
        t_dev = time_ms(lambda: ex(feat), device_only=True)
        parts = {"forward": plan.partition, "backward": plan.partition_bwd}
        for s in rep.schedules:
            which = s.schedule.rsplit("/", 1)[1]
            m = s.measured
            row = dict(s.to_row(), case=name, variant=cfg.variant,
                       dtype=cfg.feat_dtype, D=d, config=cfg.astuple(),
                       dev_p50_us=m.device_p50 * 1e6,
                       **run_stats(parts[which]),
                       model=_model_row(plan, parts[which], d))
            if which == "forward":
                row["time_ms_device"] = t_dev
                ratio = m.device_p50 * 1e3 / t_dev
                row["harness_ratio"] = ratio
                check(1 / HARNESS_AGREEMENT <= ratio <= HARNESS_AGREEMENT,
                      f"profile {name}: measure's device p50 "
                      f"{m.device_p50 * 1e3:.4f} ms vs time_ms "
                      f"{t_dev:.4f} ms (ratio {ratio:.2f})")
            rows.append(row)
            points.append(_point(f"profile_plan {s.schedule}",
                                 plan.graph_props, d, cfg,
                                 parts[which].num_tiles, m))
            log(f"  {s.schedule} [{cfg.variant} {cfg.feat_dtype} D={d} "
                f"{cfg.astuple()}]: p50={row['p50_us']:.1f}us "
                f"p90={row['p90_us']:.1f}us dev p50={row['dev_p50_us']:.1f}us"
                f" model={row['model_latency_us']:.1f}us residual="
                f"{row['residual']:.3f} bytes/s="
                f"{row['achieved_bytes_per_s']:.3e} edges/s="
                f"{row['achieved_edges_per_s']:.3e} model device="
                f"{row['model']['t_device'] * 1e6:.1f}us tiles={row['tiles']} "
                f"runs={row['runs']} hub={row['hub_live_slots']} slots"
                + (f" time_ms(device)={t_dev * 1e3:.1f}us" if which ==
                   "forward" else ""))
        log(f"  {name}: total p50={rep.total.p50 * 1e6:.1f}us attribution "
            f"error={err:.3f}")
        rows.append({"case": name, "schedule": f"{name}/total",
                     "p50_us": rep.total.p50 * 1e6, "attribution_error": err})
        del ex, feat
    out["profile_rows"] = rows
    torch.cuda.empty_cache()

    # B. select_variant_measured on pubmed serving plans (ego batches of
    # phase 3's gcn-f32 widths) at D 16 and D 500
    t0 = time.time()
    measured = []
    real_measure = profile_mod.measure

    def recording(*a, **k):
        m = real_measure(*a, **k)
        measured.append(m)
        return m

    res = serve_gnn.run(PROFILE_SERVE + ["--requests", "64"])
    check(res["ok"], "profile: the serving run for the race plans failed")
    ents = sorted(res["engine"].cache._plans.values(),
                  key=lambda e: e.plan.partition.num_tiles)
    race_plans = [ents[0], ents[-1]] if len(ents) > 1 else ents
    races = []
    for ent in race_plans:
        plan = ent.plan
        stats = run_stats(plan.partition)
        for d in RACE_DIMS:
            ga.reset_launches()
            measured.clear()
            with mock.patch.object(profile_mod, "measure", recording):
                best, p50s = select_variant_measured(
                    plan, backend=PROFILE_BACKEND, device=DEVICE, dim=d,
                    iters=RACE_ITERS, warmup=RACE_WARMUP, registry=reg)
            counts = dict(ga.launches)
            tally()
            _check_counts(counts, {ga.KERNEL_OF_VARIANT[v]: _calls(m, RACE_ITERS)
                                   for v, m in zip(p50s, measured)},
                          f"race D={d}")
            check(p50s[best] <= p50s["folded"] * (1 + RACE_MARGIN),
                  f"race D={d}: winner {best} slower than folded {p50s}")
            case = KernelCase(ent.executor.sched, plan.graph,
                              plan.partition.edge_values_csr(), d,
                              torch.float32, best, plan.config.dt, seed=d,
                              device=DEVICE)
            rec = case.check()
            KernelCase.holds(rec, f"race winner {best} at D={d}")
            del case
            for v, m in zip(p50s, measured):
                points.append(_point(
                    "race", plan.graph_props, d,
                    dataclasses.replace(plan.config, variant=v),
                    plan.partition.num_tiles, m))
            race = {"D": d, "winner": best, "config": plan.config.astuple(),
                    "race_p50_us": {v: p * 1e6 for v, p in p50s.items()},
                    "p50_us": {v: m.p50 * 1e6
                               for v, m in zip(p50s, measured)},
                    "dev_p50_us": {v: m.device_p50 * 1e6
                                   for v, m in zip(p50s, measured)},
                    "model_us": {v: _model_row(plan, plan.partition, d,
                                               v)["t_device"] * 1e6
                                 for v in p50s},
                    "winner_err_scaled": rec["max_err_scaled"],
                    "winner_over_bound": rec["over_bound"], **stats}
            races.append(race)
            log(f"  race D={d} on {stats['tiles']} tiles ({stats['edges']} "
                f"edges, {stats['runs']} runs): winner {best}; " + ", ".join(
                    f"{v} p50 {race['p50_us'][v]:.1f}us dev "
                    f"{race['dev_p50_us'][v]:.1f}us model device "
                    f"{race['model_us'][v]:.1f}us" for v in p50s)
                + f"; winner vs plain {rec['max_err_scaled']:.2e}")
    out["races"] = races
    del res, ents, race_plans
    torch.cuda.empty_cache()
    log(f"profile: races done ({time.time() - t0:.1f}s)")

    # C. measured_tune: the pubmed replica at D 500, full reddit at D 64
    tunes = []
    for name, g, d in (("pubmed", pubmed, 500), ("reddit", reddit, 64)):
        t0 = time.time()
        parts = {}
        real_partition = tuner_mod.partition_graph

        def capturing(*a, **k):
            p = real_partition(*a, **k)
            parts[(k["gs"], k["gpt"], k["src_win"])] = run_stats(p)
            return p

        ga.reset_launches()
        measured.clear()
        with mock.patch.object(tuner_mod, "partition_graph", capturing), \
                mock.patch.object(profile_mod, "measure", recording):
            res = measured_tune(
                g, d, top_k=2, backend=PROFILE_BACKEND, device=DEVICE, iters=4,
                measure_iters=RACE_ITERS, warmup=RACE_WARMUP,
                props=(plan_r.graph_props if name == "reddit" else None))
        counts = dict(ga.launches)
        tally()
        want = {}
        for (_, v), m in zip(res.measured, measured):
            k = ga.KERNEL_OF_VARIANT[v]
            want[k] = want.get(k, 0) + _calls(m, RACE_ITERS)
        _check_counts(counts, want, f"measured_tune {name}")
        props = (plan_r.graph_props if name == "reddit" and
                 plan_r.graph_props is not None
                 else extract_graph_props(g, detect_communities=False))
        table = []
        for ((cfg, v), p50), m in zip(res.measured.items(), measured):
            st = parts[(cfg.gs, cfg.gpt, cfg.src_win)]
            c_v = dataclasses.replace(cfg, variant=v)
            points.append(_point(f"measured_tune {name}", props, d, c_v,
                                 st["tiles"], m))
            table.append({"config": cfg.astuple(), "variant": v,
                          "race_p50_us": p50 * 1e6, "p50_us": m.p50 * 1e6,
                          "dev_p50_us": m.device_p50 * 1e6,
                          "predict_tiles": predict_tiles(props, cfg),
                          "model_us": KernelModel().terms(
                              props, d, c_v, tiles=st["tiles"])["t_device"]
                          * 1e6, **st})
        best = res.best
        tunes.append({"graph": name, "D": d, "best": best.astuple(),
                      "best_variant": best.variant,
                      "best_p50_us": res.best_score * 1e6, "table": table,
                      "seconds": time.time() - t0})
        log(f"  measured_tune {name} D={d}: best {best.astuple()} "
            f"{best.variant} p50 {res.best_score * 1e6:.1f}us "
            f"({time.time() - t0:.1f}s)")
        for r in table:
            log(f"    {r['config']} {r['variant']}: p50 {r['p50_us']:.1f}us "
                f"dev {r['dev_p50_us']:.1f}us model device "
                f"{r['model_us']:.1f}us "
                f"tiles {r['tiles']} (predict_tiles "
                f"{r['predict_tiles']:.0f}) runs {r['runs']} hub "
                f"{r['hub_live_slots']} slots")
        del res
        torch.cuda.empty_cache()
    out["tunes"] = tunes

    # the repriced model against the races on the pubmed replica: wherever
    # the two kernels' measured p50s differ by more than the race's margin,
    # the model must rank them in the measured order
    pairs = [(f"race D={r['D']} {r['tiles']} tiles", r["race_p50_us"],
              r["model_us"]) for r in races]
    for t in tunes:
        if t["graph"] != "pubmed":
            continue
        for cfg in dict.fromkeys(r["config"] for r in t["table"]):
            rs = {r["variant"]: r for r in t["table"] if r["config"] == cfg}
            pairs.append((f"measured_tune pubmed D={t['D']} {cfg}",
                          {v: r["race_p50_us"] for v, r in rs.items()},
                          {v: r["model_us"] for v, r in rs.items()}))
    ranking = []
    for what, meas, model in pairs:
        f, g = meas["folded"], meas["direct"]
        decided = abs(f - g) > RACE_MARGIN * max(f, g)
        agrees = (model["folded"] < model["direct"]) == (f < g)
        ranking.append({"what": what, "measured_us": meas, "model_us": model,
                        "decided": decided, "agrees": agrees})
        log(f"  ranking {what}: measured folded {f:.1f} / direct {g:.1f}us,"
            f" model {model['folded']:.1f} / {model['direct']:.1f}us"
            + ("" if decided else " (within the margin)"))
        check(agrees or not decided, f"KernelModel ranks {what} against the "
              f"measured order: measured {meas}, model {model}")
    out["ranking"] = ranking
    # the shipped costs against this run's points (`tools/fit_kernel_costs.py`
    # refits them from ``profile.points`` of the detail file)
    out["points"] = points
    host = statistics.median(p["wall_s"] - p["dev_s"] for p in points)
    log(f"  host share of a call (median wall - device p50): "
        f"{host * 1e6:.1f}us")
    for v in ("folded", "direct"):
        rs = [p["dev_s"] / p["model_dev_s"] for p in points
              if p["variant"] == v]
        log(f"  {v}: device measured / model over {len(rs)} points "
            f"{min(rs):.2f}-{max(rs):.2f}")

    # D. serving through a shared PlanCache(measure_variants=True)
    t0 = time.time()
    cache = PlanCache(measure_variants=True, backend=PROFILE_BACKEND, device=DEVICE,
                      tune_iters=4, seed=0, registry=reg)
    ga.reset_launches()
    res = serve_gnn.run(PROFILE_SERVE + ["--requests", "128"], cache=cache)
    counts = dict(ga.launches)
    tally()
    st = cache.stats()
    eng = res["engine"]
    winners = set(cache._variants.values())
    # each selection: warmup 2 + wall (and on the card device) samples of
    # each candidate
    measured_calls = st["variant_selections"] * (
        2 + cache.variant_measure_iters * (2 if DEVICE == "cuda" else 1))
    served = {v: counts[ga.KERNEL_OF_VARIANT[v]] - (
        measured_calls if v in tuner_mod.MEASURED_VARIANTS else 0)
        for v in ga.VARIANTS}
    log(f"  measured serving: stats {st} winners {sorted(winners)} launches "
        f"{ {k: v for k, v in counts.items() if v} } served {served} "
        f"req/s={res['summary']['req_per_s']:.1f} "
        f"verify={res['verify_err']:.2e}")
    check(res["ok"], f"measured serving: verify/cache check failed "
          f"({res['verify_err']})")
    check(st["variant_selections"] >= 1 and st["variant_memo_hits"] >= 1,
          f"measured serving: selections/memo hits {st}")
    check(counts[ga.PLAIN] == 0, f"measured serving: plain ran "
          f"{counts[ga.PLAIN]} times")
    for v, n in served.items():
        check((n > 0) == (v in winners) and n >= 0,
              f"measured serving: {v} served {n} launches, winners "
              f"{sorted(winners)}")
    done_reqs = [r for r in res["requests"] if r.status == "done"][:4]
    terr = _engine_err(eng, done_reqs, backend="torch")
    check(terr <= TOL, f"measured serving vs torch engine {terr:.2e}")
    out["measured_serving"] = {
        "stats": st, "winners": sorted(winners), "launches": counts,
        "served_launches": served, "verify_err": res["verify_err"],
        "torch_engine_err": terr, "req_per_s": res["summary"]["req_per_s"],
        "seconds": time.time() - t0}
    del res, eng, cache
    torch.cuda.empty_cache()

    # E. --trace-out on serve_gnn (sync and async) and train
    t0 = time.time()
    tdir = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    traces = {}
    runs = [("serve-sync", lambda p: serve_gnn.run(
                PROFILE_SERVE + ["--requests", "32", "--trace-out", p]),
             "compute", 1),
            ("serve-async", lambda p: serve_gnn.run(
                PROFILE_SERVE + ["--requests", "24", "--tenants", "3",
                                 "--policy", "deadline", "--rate", "30",
                                 "--trace-out", p]), "compute", 2),
            ("train", lambda p: train.run(
                ["--arch", "gcn", "--variant", "folded", "--ckpt-dir",
                 os.path.join(tdir, "ckpt")] + TRAIN_COMMON
                + ["--steps", "5", "--trace-out", p]), "train", 1)]
    for name, fn, span, threads in runs:
        path = os.path.join(tdir, f"{name}.json")
        res = fn(path)
        check(res["ok"], f"trace run {name} failed")
        traces[name] = _trace_check(path, span, threads)
        log(f"  --trace-out {name}: {traces[name]['events']} spans on "
            f"{traces[name]['threads']} threads: "
            f"{traces[name]['names'][:6]}")
        del res
    out["traces"] = traces
    log(f"profile: traces done ({time.time() - t0:.1f}s)")

    problems = lint_prometheus(to_prometheus_text(reg))
    check(not problems, f"profile registry does not lint: {problems[:3]}")
    detail["profile"] = out
    return out


# phase 10: LM training.  (a) drives the main path: h2o-danube-1.8b at
# its published width and depth through the training driver
LM_TRAIN_ARGV = ["--arch", "h2o-danube-1.8b", "--full", "--global-batch",
                 "8", "--n-micro", "2", "--seq-len", "4096", "--warmup", "1",
                 "--steps", "6", "--ckpt-every", "1000"]
LM_TRAIN_PARAMS = 1_831_201_280      # the JAX package's count of full()
# (b) flash backward at full head dims: (what, B, S, H, hd, window, softcap)
FLASH_GRAD_CASES = [("h2o", 1, 4096, 32, 80, 4096, None),
                    ("gemma2-local", 1, 8192, 8, 256, 4096, 50.0)]
FLASH_GRAD_TOL = 1e-4
# (c) chunked cross-entropy at full vocabularies: (what, B, S, d, V, softcap)
XENT_CASES = [("h2o", 2, 2048, 2560, 32_000, None),
              ("gemma2", 2, 2048, 2304, 256_000, 30.0)]
# (d) Falcon-Mamba at full width, depth cut to 2 layers
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 2, 1, 1024
# (e) one float32 step of jamba's reduced config, card vs CPU
JAMBA_STEP_TOL = 1e-4


def _lm_batch(cfg, B: int, S: int, seed: int, device) -> dict:
    """The training driver's batch (`repro_torch.data`, step 0)."""
    import torch

    from repro_torch.data import PipelineConfig, TokenPipeline, make_lm_batch
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=S,
                                        global_batch=B, seed=seed))
    b = make_lm_batch(pipe.batch(0), frontend=cfg.frontend,
                      d_model=cfg.d_model, mrope=(cfg.rope == "mrope"))
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def lm_train(detail: dict) -> dict:
    """Phase 10: LM training.  (a) h2o-danube-1.8b at full width and depth
    through `repro_torch.launch.train.run`; (b) flash attention's backward
    against plain autograd at full head dims; (c) the chunked
    cross-entropy against the dense one at full vocabularies; (d)
    Falcon-Mamba at full width on the chunked path, the scan's refusal;
    (e) jamba's reduced config, one float32 step on the card vs the
    CPU."""
    import dataclasses
    import math
    import tempfile

    import torch

    from repro_torch.configs import falcon_mamba_7b, jamba_v0_1_52b
    from repro_torch.device import set_matmul_precision
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch import train as train_mod
    from repro_torch.models.lm import LMModel, make_train_step
    from repro_torch.nn.attention import blockwise_attention
    from repro_torch.nn.losses import chunked_softmax_xent, softmax_xent_dense
    from repro_torch.nn.transformer import param_count
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.checkpoint import _leaves, _rebuild

    rec = {}
    set_matmul_precision()

    # (a) the full-width run, the main path: no kernel and no plain call
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with tempfile.TemporaryDirectory() as ckpt:
        res = train_mod.run(LM_TRAIN_ARGV + ["--ckpt-dir", ckpt])
    counts = _all_counts()
    check(all(v == 0 for v in counts.values()),
          f"lm-train: the Mamba-free path launched {counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer, cfg = res["trainer"], res["cfg"]
    losses = [m["loss"] for m in res["history"]]
    n_params = param_count(trainer.state[0])
    check(n_params == LM_TRAIN_PARAMS,
          f"lm-train: {cfg.name} holds {n_params:,} parameters, not "
          f"{LM_TRAIN_PARAMS:,}")
    check(res["ok"] and all(math.isfinite(l) for l in losses),
          f"lm-train: losses not finite: {losses}")
    check(losses[-1] < losses[0],
          f"lm-train: the loss did not fall: {losses}")
    gb = int(LM_TRAIN_ARGV[LM_TRAIN_ARGV.index("--global-batch") + 1])
    seq = int(LM_TRAIN_ARGV[LM_TRAIN_ARGV.index("--seq-len") + 1])
    tokens = gb * seq
    step_s = res["avg_step_s"]                       # mean of steps 2..n
    # model FLOPs a step: 6 N T for the dense products, plus the
    # attention term 12 L H hd S T (forward and backward of QK^T and PV)
    model_flop = (6 * n_params + 12 * cfg.n_layers * cfg.n_heads
                  * cfg.head_dim * seq) * tokens
    rec.update(arch=cfg.name, n_params=n_params, losses=losses,
               step_ms=step_s * 1e3,
               step_ms_all=[m["step_time_s"] * 1e3 for m in res["history"]],
               tok_per_s=tokens / step_s, model_flop=model_flop,
               mfu=model_flop / step_s / H100_SXM.peak_flops_bf16,
               peak_gb=peak_gb, launches=counts, wall_s=res["wall_s"])
    log(f"lm-train: {cfg.name} {n_params:,} params {cfg.dtype}, B {gb} x S "
        f"{seq} in 2 micro-batches, remat {cfg.remat}; losses "
        + ", ".join(f"{l:.4f}" for l in losses))
    log(f"lm-train step ms (mean of steps 2-{len(losses)}): "
        f"{rec['step_ms']:.1f} (" + ", ".join(
            f"{t:.1f}" for t in rec["step_ms_all"]) + ")")
    log(f"lm-train tok/s: {rec['tok_per_s']:.0f}")
    log(f"lm-train model-FLOP share of the bf16 dense peak "
        f"({H100_SXM.peak_flops_bf16:.3g} FLOP/s; (6 N + 12 L H hd S) T = "
        f"{model_flop:.4g} FLOP a step): {rec['mfu']:.4f}")
    log(f"lm-train peak memory: {peak_gb:.2f} GB")
    batch = trainer.batch_fn(trainer.step)
    prof = _profile(lambda: trainer.step_fn(trainer.state, batch))
    rec["profile_step"] = prof
    log(f"lm-train step profile: wall {prof['wall_ms']:.1f} ms, device "
        f"{prof['device_ms']:.1f} ms, idle share {prof['idle_share']:.4f}; "
        "by kind: " + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
            prof["by_kind_ms"].items(), key=lambda kv: -kv[1]))
        + "; top: " + "; ".join(f"{r['name'][:60]} {r['ms']:.1f} ms x"
                                f"{r['count']}" for r in prof["top"][:8]))
    del res, trainer, batch
    torch.cuda.empty_cache()

    # (b) flash attention's backward vs plain autograd (float32)
    rec["flash"] = []
    for what, B, S, H, hd, window, softcap in FLASH_GRAD_CASES:
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        q, k, v, go = (torch.randn(B, S, H, hd, generator=gen, device=DEVICE)
                       for _ in range(4))
        pos = torch.arange(S, device=DEVICE)
        got = {}
        for mode in ("flash", "masked_full"):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = blockwise_attention(*ins, q_pos=pos, kv_pos=pos,
                                      window=window, softcap=softcap,
                                      causal_mode=mode)
            grads = torch.autograd.grad(out, ins, go)
            torch.cuda.synchronize()
            got[mode] = ((out.detach(),) + grads,
                         (time.perf_counter() - t0) * 1e3)
            del ins, out, grads
        err = max(_nerr(a, b) for a, b in zip(got["flash"][0],
                                              got["masked_full"][0]))
        r = {"what": what, "B": B, "S": S, "H": H, "hd": hd,
             "window": window, "softcap": softcap, "max_err": err,
             "flash_ms": got["flash"][1], "masked_full_ms":
             got["masked_full"][1]}
        rec["flash"].append(r)
        log(f"lm-train flash backward {what} (B {B}, S {S}, H {H}, hd {hd}, "
            f"window {window}, softcap {softcap}): out/dq/dk/dv vs "
            f"masked_full autograd {err:.3e}; fwd+bwd {r['flash_ms']:.1f} ms "
            f"(masked_full {r['masked_full_ms']:.1f} ms, host clock)")
        check(err <= FLASH_GRAD_TOL,
              f"flash backward {what}: {err:.3e} > {FLASH_GRAD_TOL}")
        del got, q, k, v, go
        torch.cuda.empty_cache()

    # (c) chunked vs dense cross-entropy; the chunked backward's extra
    # memory beside the dense one's
    rec["xent"] = []
    for what, B, S, d, V, softcap in XENT_CASES:
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        x = torch.randn(B, S, d, generator=gen, device=DEVICE)
        w = torch.randn(d, V, generator=gen, device=DEVICE) / math.sqrt(d)
        labels = torch.randint(0, V, (B, S), generator=gen, device=DEVICE)
        got = {}
        for name, fn, kw in (("chunked", chunked_softmax_xent,
                              {"chunk": 512}),
                             ("dense", softmax_xent_dense, {})):
            xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = fn(xi, wi, labels, z_loss=1e-4, logit_softcap=softcap,
                         **kw)
            grads = torch.autograd.grad(loss, (xi, wi))
            torch.cuda.synchronize()
            got[name] = ((loss.detach(),) + grads,
                         (time.perf_counter() - t0) * 1e3,
                         (torch.cuda.max_memory_allocated() - base) / 1e9)
            del xi, wi, loss, grads
        err = max(_nerr(a, b) for a, b in zip(got["chunked"][0],
                                              got["dense"][0]))
        r = {"what": what, "B": B, "S": S, "d": d, "V": V,
             "softcap": softcap, "max_err": err,
             "chunked_ms": got["chunked"][1], "dense_ms": got["dense"][1],
             "chunked_extra_gb": got["chunked"][2],
             "dense_extra_gb": got["dense"][2]}
        rec["xent"].append(r)
        log(f"lm-train chunked xent {what} (B {B}, S {S}, d {d}, V {V}, "
            f"softcap {softcap}): loss/dx/dW vs dense {err:.3e}; fwd+bwd "
            f"{r['chunked_ms']:.1f} ms (dense {r['dense_ms']:.1f}, host "
            f"clock); extra memory {r['chunked_extra_gb']:.2f} GB (dense "
            f"{r['dense_extra_gb']:.2f} GB)")
        check(err <= TOL, f"chunked xent {what}: {err:.3e} > {TOL}")
        check(r["chunked_extra_gb"] < 0.5 * r["dense_extra_gb"],
              f"chunked xent {what}: extra memory {r['chunked_extra_gb']:.2f}"
              f" GB is not below half the dense {r['dense_extra_gb']:.2f} GB")
        del got, x, w, labels
        torch.cuda.empty_cache()

    # (d) Falcon-Mamba at full width, depth cut: the chunked path runs no
    # kernel; the scan wrapper refuses a gradient on the card
    mcfg = dataclasses.replace(falcon_mamba_7b.full(),
                               n_layers=MAMBA_TRAIN_LAYERS)
    model = LMModel.create(mcfg, seed=0, device=DEVICE)
    mbatch = _lm_batch(mcfg, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, 0, DEVICE)
    mstep = make_train_step(mcfg, AdamWConfig(lr=1e-4)).step
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, mm = mstep(model.params, adamw_init(model.params), mbatch)
    torch.cuda.synchronize()
    counts = _all_counts()
    m_ms = (time.perf_counter() - t0) * 1e3
    check(all(v == 0 for v in counts.values()),
          f"lm-train mamba: the chunked path launched {counts}")
    check(math.isfinite(float(mm["grad_norm"])) and float(mm["grad_norm"]) > 0
          and all(bool(torch.isfinite(p).all()) for p in _leaves(params)),
          f"lm-train mamba: gradient norm {float(mm['grad_norm'])}")
    scan_args = [a.requires_grad_(i == 0) for i, a in enumerate(
        scan_inputs(1, 64, 256, 16, seed=0))]
    try:
        ss.selective_scan(*scan_args)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused and sum(_all_counts().values()) == 0,
          "lm-train: the scan wrapper did not refuse a gradient on the card")
    rec["mamba"] = {"layers": MAMBA_TRAIN_LAYERS, "n_params":
                    param_count(params), "B": MAMBA_TRAIN_BATCH,
                    "S": MAMBA_TRAIN_SEQ, "step_ms": m_ms,
                    "loss": float(mm["loss"]),
                    "grad_norm": float(mm["grad_norm"]),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": counts, "refused": refused}
    log(f"lm-train mamba: falcon-mamba-7b at {MAMBA_TRAIN_LAYERS} layers "
        f"({rec['mamba']['n_params']:,} params, d_inner "
        f"{mcfg.mamba.d_inner}) B {MAMBA_TRAIN_BATCH} S {MAMBA_TRAIN_SEQ}: "
        f"one step {m_ms:.1f} ms (first call), loss {rec['mamba']['loss']:.4f}"
        f", grad norm {rec['mamba']['grad_norm']:.4f}, launches {counts}, "
        f"peak {rec['mamba']['peak_gb']:.2f} GB; selective_scan refused a "
        f"gradient on the card")
    del model, params, mbatch, scan_args
    torch.cuda.empty_cache()

    # (e) jamba reduced, float32: one step on the card vs the CPU
    jcfg = jamba_v0_1_52b.reduced()
    cpu = LMModel.create(jcfg, seed=0, device="cpu").params
    card = _rebuild(cpu, iter([t.to(DEVICE) for t in _leaves(cpu)]))
    opt = AdamWConfig(lr=3e-3)
    out = {}
    for dev, params in (("cpu", cpu), (DEVICE, card)):
        out[dev] = make_train_step(jcfg, opt, donate=False).step(
            params, adamw_init(params), _lm_batch(jcfg, 4, 64, 0, dev))
    (cp, cs, cm), (gp, gs, gm) = out["cpu"], out[DEVICE]
    errs = {k: _nerr(gm[k].cpu(), cm[k]) for k in ("loss", "grad_norm")}
    errs["m"] = max(_nerr(a.cpu(), b) for a, b in zip(_leaves(gs.m),
                                                      _leaves(cs.m)))
    errs["v"] = max(_nerr(a.cpu(), b) for a, b in zip(_leaves(gs.v),
                                                      _leaves(cs.v)))
    # Adam's first step is about sign(g) lr: where the gradient (10 m) is
    # within the limit of zero, its sign is rounding
    worst, sign_noise = 0.0, 0
    for a, b, m in zip(_leaves(gp), _leaves(cp), _leaves(cs.m)):
        a, b, g = a.cpu().double(), b.double(), 10.0 * m.double()
        near_zero = g.abs() <= JAMBA_STEP_TOL * (1 + g.abs().max())
        diff = (a - b).abs() / (1 + b.abs().max())
        worst = max(worst, float(diff[~near_zero].max()) if (~near_zero).any()
                    else 0.0)
        check(bool((diff[near_zero] <= 2 * opt.lr + JAMBA_STEP_TOL).all()),
              "lm-train jamba: a near-zero-gradient parameter moved by more "
              "than 2 lr")
        sign_noise += int((diff[near_zero] > JAMBA_STEP_TOL).sum())
    errs["params"] = worst
    rec["jamba_step"] = dict(errs, sign_noise=sign_noise)
    log(f"lm-train jamba reduced f32 step, card vs CPU: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f"; {sign_noise} parameters part by up to 2 lr where the gradient "
        f"is within {JAMBA_STEP_TOL:g} of zero")
    check(max(errs.values()) <= JAMBA_STEP_TOL,
          f"lm-train jamba step card vs CPU: {errs}")
    detail["lm_train"] = rec
    return rec


PHASES = {"kernels": kernel_sweeps, "hub": hub_probe, "serving": serving,
          "async": async_serving, "edge-grad": edge_grad_checks,
          "training": training, "sampled": sampled_training,
          "dynamic": dynamic_plans, "profile": profiling, "scan": scan_checks,
          "lm": lm_serving, "lm-hybrid": lm_hybrid, "lm-train": lm_train}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of phases 2-10 to run "
                         f"({', '.join(PHASES)}; default all); the device "
                         "phase always runs")
    ap.add_argument("--scan-variants", default="",
                    help="comma-separated names of the scan kernel's probe "
                         "instantiations (`kProbes` in selective_scan.cu) "
                         "that phases 6 and 7 also check and time beside "
                         "the shipped launch (default: none)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    global SCAN_VARIANTS
    SCAN_VARIANTS = tuple(v for v in args.scan_variants.split(",") if v)
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
        for name, lines in sorted(ptxas.items()):
            log(f"  ptxas {name}: " + " | ".join(lines))
        detail.update(card=card, ptxas=ptxas)

        done = {}
        for name, fn in PHASES.items():
            if name in phases:
                t0 = time.time()
                done[name] = fn(detail)
                log(f"phase {name}: {time.time() - t0:.1f}s")
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1

    from repro_torch.kernels.group_aggregate import (
        EDGE_GRAD_KERNEL_OF_VARIANT, KERNEL_OF_VARIANT)
    kernels = []
    sweeps, at_serving = done.get("kernels", []), done.get("serving", {})
    edge_sweeps, at_training = (done.get("edge-grad", []),
                                done.get("training", {}))
    at_sampled = done.get("sampled", [])
    at_dynamic = done.get("dynamic", [])
    for variant, kname in KERNEL_OF_VARIANT.items():
        if kname not in at_serving:
            continue
        rec = at_serving[kname]
        sampled = [r for r in at_sampled if r["variant"] == variant]
        checks = [r for r in sweeps + at_dynamic
                  if r["variant"] == variant] + [rec] + sampled
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
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "library_device_ms": rec["library_device_ms"],
            "phase": rec["phase"],
            "shape": {k: rec[k] for k in ("tiles", "live_tiles", "gpt", "gs",
                                          "src_win", "nodes", "edges", "D",
                                          "dt", "dtype")},
            "launches_per_batch": rec["launches_per_batch"],
            "batches_served": rec["batches_served"],
            **({"launches_sampled": sum(d["launches"].get(kname, 0)
                                        for d in detail["sampled"])}
               if sampled else {}),
            **({"launches_async": done["async"]["launches"]}
               if variant == "folded" and "async" in done else {}),
            **({"launches_profile": done["profile"]["launches"].get(kname, 0)}
               if "profile" in done else {})})
    for variant, rname in EDGE_GRAD_RECORDS.items():
        if rname not in at_training:
            continue
        rec = at_training[rname]
        checks = [r for r in edge_sweeps if r["variant"] == variant] + [rec]
        source, replaces = SOURCES[rname]
        kernels.append({
            "name": rname, "counter": EDGE_GRAD_KERNEL_OF_VARIANT[variant],
            "variant": variant, "route": "cuda", "source": source,
            "replaces": replaces, "launches": rec["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in checks),
            "max_err": max(r["max_err"] for r in checks),
            "max_err_scaled": max(r["max_err_scaled"] for r in checks),
            "err_f64": max(r["err_f64"] for r in checks),
            "plain_err_f64": max(r["plain_err_f64"] for r in checks),
            "over_bound": max(r["over_bound"] for r in checks),
            "plain_over_bound": max(r["plain_over_bound"] for r in checks),
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "library_device_ms": rec["library_device_ms"],
            "phase": rec["phase"],
            "shape": {k: rec[k] for k in ("tiles", "live_tiles", "gpt", "gs",
                                          "src_win", "nodes", "edges", "D",
                                          "dt", "dtype")},
            "launches_per_step": rec["launches_per_step"]})
    if "scan" in done:
        checks = list(done["scan"].values())
        rec = done["scan"][SCAN_TIMED]
        lm = done.get("lm", {})
        source, replaces = SOURCES["selective_scan"]
        kernels.append({
            "name": "selective_scan", "route": "cuda", "source": source,
            "replaces": replaces, "launches": lm.get("launches", 0),
            "max_abs_err": max(r["max_abs_err"] for r in checks),
            "err_plain": max(r["err_plain"] for r in checks),
            "err_f64": max(r["err_f64"] for r in checks),
            "plain_err_f64": max(r["plain_err_f64"] for r in checks),
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "sfu_ms": rec["sfu_ms"], "library_ms": None,
            "lanes": rec["lanes"],
            "phase": "scan (timed shape); lm prefill (launches)",
            "shape": {k: rec[k] for k in ("B", "S", "d_inner", "N")},
            "launches_per_prefill": lm.get("launches_per_prefill"),
            "prefill_ms": lm.get("prefill_ms"),
            "launches_hybrid": done.get("lm-hybrid", {}).get("launches")})
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
