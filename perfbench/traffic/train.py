"""Full-graph training, a closed loop.

Set-up plans the graph with its backward schedule, builds the step
(`make_gnn_train_step` with the mix's AdamW) and drives it through the
checked steps and the warm-up steps, all through the window's own call
on the window's own batch.  The window then runs that same step on that
same state until ``--seconds`` have passed, reading each step's metrics
back to the host as the port's trainer does.  ``epoch_ms`` is the
window's wall time over the steps it completed.  A traced run ends its
window with the traced stretch: it reports no end-to-end metric.

After the window the plain reference follows the checked steps from the
same weights and inputs, and `check.train_numbers` compares them.
"""
from __future__ import annotations

import time

import torch

from perfbench import check
from perfbench.devtrace import TracedWindow
from perfbench.harness import Outcome
from perfbench.inputs import make_inputs
from perfbench.reference import gnn as ref
from perfbench.system import build_system


def make_step(ctx, sysm):
    from repro_torch.models.gnn import make_gnn_train_step
    from repro_torch.optim.adamw import AdamWConfig
    opt = ctx.mix["optimizer"]
    return make_gnn_train_step(sysm.model, AdamWConfig(
        lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"]))


def first_steps(ctx, sysm, step_fn, inp):
    """The batch in the plan's order, and the state after the checked
    steps with what the comparison reads of them: each step's loss, the
    gradient AdamW got first (its first moment after one step over 1 -
    b1), and the parameters' change over the checked steps."""
    from repro_torch.optim.adamw import adamw_init
    batch = {"feat": sysm.to_plan(inp["feat"]),
             "labels": sysm.to_plan(inp["labels"]),
             "mask": sysm.to_plan(inp["mask"])}
    p0 = {k: v.clone() for k, v in inp["params"].items()}
    state = (inp["params"], adamw_init(inp["params"]))
    losses, grad = [], None
    for i in range(ctx.mix["checked_steps"]):
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))
        if i == 0:
            b1 = ctx.mix["optimizer"]["b1"]
            grad = {k: m / (1.0 - b1) for k, m in state[1].m.items()}
    move = {k: state[0][k] - p0[k] for k in p0}
    return batch, state, (losses, grad, move), p0


def reference_readings(ctx, inp, p0, adj, matmul=torch.matmul, mask=None,
                       dtype=torch.float64, opt=None):
    """The same readings from the plain reference, in float64 (``matmul``,
    ``mask``, ``dtype`` and ``opt`` let the control and a planted fault
    take its place)."""
    q0 = {k: v.to(dtype) for k, v in p0.items()}
    losses, grad, p = ref.train(
        ctx.arch, ctx.config["model"], opt or ctx.mix["optimizer"], q0,
        inp["feat"].to(dtype), inp["labels"],
        (inp["mask"] if mask is None else mask).to(dtype), adj,
        ctx.mix["checked_steps"], matmul)
    return losses, grad, {k: p[k] - q0[k] for k in q0}


def adjacency(ctx):
    return ctx.arch.adjacency(ctx.graph.indptr, ctx.graph.indices,
                              ctx.device)


def run(ctx) -> Outcome:
    sysm = build_system(ctx, with_backward=True)
    g = ctx.graph
    inp = make_inputs(ctx.arch, ctx.config, ctx.seed, g.num_nodes,
                      g.num_edges / g.num_nodes, ctx.device)
    step_fn = make_step(ctx, sysm)
    batch, state, prog, p0 = first_steps(ctx, sysm, step_fn, inp)
    for _ in range(ctx.mix["warmup_steps"]):
        state, met = step_fn(state, batch)
        {k: float(v) for k, v in met.items()}
    ctx.sync()

    win = TracedWindow(ctx.trace, ctx.device)
    win.prepare()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    end = t_start + ctx.seconds
    win.start()
    steps = 0
    while True:
        state, met = step_fn(state, batch)
        {k: float(v) for k, v in met.items()}
        steps += 1
        now = time.perf_counter()
        if win.active and now - t_start >= ctx.mix["trace_seconds"]:
            win.stop(steps)
        if now >= end or win.summary is not None:
            break
    win.stop(steps)
    wall = now - t_start
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)

    # the program's state is freed before the reference runs
    plan_s = sysm.plan_s
    del state, met, step_fn, batch, sysm
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.train_numbers(
        *prog, *reference_readings(ctx, inp, p0, adjacency(ctx)))
    return Outcome(
        end_to_end={"setup_s": setup_s, "epoch_ms": wall / steps * 1e3,
                    "peak_gb": peak / 1e9},
        attempted=steps, numbers=numbers, plan_s=plan_s,
        peak_bytes=peak, trace=win.summary)
