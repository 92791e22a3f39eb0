"""Full-graph inference, a closed loop with one client.

Set-up plans the graph (forward schedule only), makes the features and
weights resident on the device and runs the warm-up requests.  In the
window each request runs `GNNModel.logits` under ``no_grad`` and copies
the predicted class of every node into a pinned buffer on the host, as a
scoring client that reuses its buffer does; the next starts when it is
back.  ``infer_ms`` is the window's wall time over the requests it
completed, ``infer_p95_ms`` the 95th percentile of their latencies.  A
traced run ends its window with the traced stretch: it reports no
end-to-end metric.

A reservoir drawn from the seed keeps a few requests' logits and answers;
after the window the plain reference scores the same inputs once and
`check.infer_numbers` compares every kept request with it.
"""
from __future__ import annotations

import math
import random
import time

import torch

from perfbench import check
from perfbench.devtrace import TracedWindow
from perfbench.harness import Outcome
from perfbench.inputs import make_inputs
from perfbench.system import build_system


def request(model, params, feat, answers=None):
    """One request: the logits, and the predicted classes on the host,
    copied into ``answers`` (a pinned buffer) where one is given."""
    with torch.no_grad():
        lg = model.logits(params, feat)
        cls = lg.argmax(-1)
        if answers is None:
            return lg, cls.cpu()
        answers.copy_(cls, non_blocking=True)
        torch.cuda.current_stream(cls.device).synchronize()
        return lg, answers


def reference_logits(ctx, inp, matmul=torch.matmul, dtype=torch.float64):
    """The reference's logits, in float64 (``matmul`` and ``dtype`` let
    the control take its place)."""
    adj = ctx.arch.adjacency(ctx.graph.indptr, ctx.graph.indices,
                             ctx.device)
    params = {k: v.to(dtype) for k, v in inp["params"].items()}
    with torch.no_grad():
        return ctx.arch.logits(ctx.config["model"], params,
                               inp["feat"].to(dtype), adj, matmul)


def run(ctx) -> Outcome:
    sysm = build_system(ctx, with_backward=False)
    g = ctx.graph
    inp = make_inputs(ctx.arch, ctx.config, ctx.seed, g.num_nodes,
                      g.num_edges / g.num_nodes, ctx.device)
    model, params = sysm.model, inp["params"]
    feat = sysm.to_plan(inp["feat"])
    answers = (torch.empty(g.num_nodes, dtype=torch.int64, pin_memory=True)
               if ctx.device.type == "cuda" else None)
    for _ in range(ctx.mix["warmup_requests"]):
        request(model, params, feat, answers)
    ctx.sync()

    keep = ctx.mix["sampled_requests"]
    rng = random.Random(ctx.seed)
    kept, lat = [], []
    win = TracedWindow(ctx.trace, ctx.device)
    win.prepare()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    end = t_start + ctx.seconds
    win.start()
    while True:
        t = time.perf_counter()
        lg, cls = request(model, params, feat, answers)
        now = time.perf_counter()
        lat.append(now - t)
        i = len(lat) - 1
        j = i if i < keep else rng.randrange(i + 1)
        if j < keep:
            out = (lg, cls if answers is None else cls.clone())
            if i < keep:
                kept.append(out)
            else:
                kept[j] = out
        if win.active and now - t_start >= ctx.mix["trace_seconds"]:
            win.stop(len(lat))
        if now >= end or win.summary is not None:
            break
    win.stop(len(lat))
    wall = now - t_start
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)

    prog_logits = [sysm.from_plan(lg) for lg, _ in kept]
    prog_classes = [sysm.from_plan(cls) for _, cls in kept]
    plan_s = sysm.plan_s
    # the program's state is freed before the reference runs
    del model, sysm, kept, lg, cls, feat
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.infer_numbers(prog_logits, prog_classes,
                                  reference_logits(ctx, inp))
    ordered = sorted(lat)
    p95 = ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
    return Outcome(
        end_to_end={"setup_s": setup_s, "infer_ms": wall / len(lat) * 1e3,
                    "infer_p95_ms": p95 * 1e3, "peak_gb": peak / 1e9},
        attempted=len(lat), numbers=numbers, plan_s=plan_s,
        peak_bytes=peak, trace=win.summary)
