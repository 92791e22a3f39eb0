"""GNN serving driver: replay a synthetic node-prediction request trace.

Port of `src/repro/launch/serve_gnn.py`:

    # synchronous micro-batcher
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn \
        --num-nodes 20000 --requests 256 --batch-window 16

    # async SLO-aware tier: deadline batcher, 3 SLO tenants, open loop,
    # four graph deltas swapped in between fired batches
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn \
        --policy deadline --slo-ms 250 --tenants 3 --rate 500 \
        --stream-deltas 4

    # on a machine without a card: the plain PyTorch versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --smoke \
        --device cpu --backend torch

Builds a power-law resident graph, initializes a GCN/GIN/GAT, then replays
a Zipf-popularity request trace.  ``--policy micro`` (default) drives the
synchronous `ServingEngine` and prints requests/s, p50/p99 latency and the
plan-cache hit rate; ``--policy deadline|clock`` — or ``--tenants > 1`` /
an explicit ``--slo-ms`` — runs the async `AsyncServingEngine` tier
instead: bounded admission, SLO classes cycled across tenants
(gold/silver/bronze over ``--slo-ms``), deadline-aware or fixed-window
batching, EDF across tenants, and per-tenant p50/p99/attainment.
``--stream-deltas N`` applies N synthetic interaction-stream deltas to the
resident graph between chunks of the replay (on the async tier the worker
swaps them in between fired batches).  Then the JSON metrics document.
``--verify N`` re-serves N requests alone (on the async tier, of the last
chunk: earlier ones answered against earlier snapshots) and checks
``max|batched - single| / (1 + |single|)`` against 1e-5 (float32) or
2e-2 (bfloat16); exit code 1 on failure.

``--trace-out PATH`` writes the run's span records (the engine's
``serve_batch`` / ``extract`` / ``plan`` / ``compute`` spans, one track
per thread: the async tier's worker is its own) as a Chrome/Perfetto
trace with `run_context()` in ``otherData``.

Port flags beside the reference's: ``--device cuda|cpu`` (default cuda;
raises without CUDA), ``--backend cuda|torch`` (hand-written kernels or
plain PyTorch) and ``--variant folded|slot_onehot|direct`` (the gather
kernel).  `run` also takes a shared `PlanCache` (``cache=``), for
example one built with ``measure_variants=True``, whose measured kernel
then overrides ``--variant``.

``--shards N`` (GCN / GIN; implies the async tier, as in the reference)
serves from the sharded full-graph forward over N rank processes
(`serving.make_sharded_serve_fn`): each fired batch runs one forward on
the ranks, inside a ``serve_sharded`` span, and the requested rows come
back.  A streamed delta re-shards incrementally and only sub-plans that
changed are sent to their ranks again; with ``--verify`` the outputs
after each delta are also held against a fresh split of the mutated
plan (1e-5).  ``--dist-backend nccl|gloo`` picks the transport (default
nccl on the card, gloo on the CPU; nccl needs N cards, gloo on the card
puts every rank on card 0):

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --shards 2 \
        --policy deadline --tenants 3 --stream-deltas 2 --smoke \
        --device cpu --backend torch
"""
from __future__ import annotations

import argparse
import json
import math
import time


def build_trace(num_nodes: int, requests: int, *, zipf: float = 1.1,
                hot_fraction: float = 0.05, seed: int = 0):
    """Power-law seed popularity (`serving.loadgen.zipf_seeds`)."""
    from repro_torch.serving.loadgen import zipf_seeds
    return zipf_seeds(num_nodes, requests, zipf=zipf,
                      hot_fraction=hot_fraction, seed=seed)


def _delta_stream(args, g):
    """Pre-draw the synthetic mutation stream for ``--stream-deltas``:
    ~1% of the resident edges per delta, new nodes carrying random
    features at the serving width."""
    from repro_torch.graphs.datasets import interaction_stream
    return list(interaction_stream(
        g, num_batches=args.stream_deltas,
        edges_per_batch=max(16, g.num_edges // 100),
        feat_dim=args.in_dim, seed=args.seed))


def _serving_config(args):
    from repro_torch.serving import ServingConfig
    return ServingConfig(hops=args.hops, max_batch=args.batch_window,
                         batch_mode=args.batch_mode,
                         bucket_shapes=args.bucket,
                         tune_iters=args.tune_iters,
                         max_plans=(None if args.max_plans == 0
                                    else args.max_plans),
                         variant=args.variant)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--num-nodes", type=int, default=20_000)
    p.add_argument("--avg-degree", type=float, default=8.0)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--batch-window", type=int, default=16,
                   help="micro-batch size budget (requests per batch)")
    p.add_argument("--arch", default="gcn", choices=["gcn", "gin", "gat"])
    p.add_argument("--in-dim", type=int, default=32)
    p.add_argument("--hidden-dim", type=int, default=32)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hops", type=int, default=None,
                   help="ego radius (default: --layers)")
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                   help="cuda = hand-written kernels, torch = plain PyTorch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--variant", default="folded",
                   choices=["folded", "slot_onehot", "direct"],
                   help="gather kernel of every plan")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="feature/activation dtype policy")
    p.add_argument("--batch-mode", default="union",
                   choices=["union", "disjoint"])
    p.add_argument("--zipf", type=float, default=1.1)
    p.add_argument("--tune-iters", type=int, default=4)
    p.add_argument("--max-plans", type=int, default=64,
                   help="plan-cache LRU bound (0 = unbounded)")
    p.add_argument("--no-bucket", dest="bucket", action="store_false",
                   default=True, help="disable shape bucketing")
    p.add_argument("--verify", type=int, default=8,
                   help="cross-check N requests vs single-request inference")
    p.add_argument("--policy", default="micro",
                   choices=["micro", "deadline", "clock"],
                   help="micro = synchronous ServingEngine; deadline/clock "
                        "= async SLO-aware tier")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="gold-class SLO budget in ms for the async tier "
                        "(silver = 2x, bronze = 4x; default 250)")
    p.add_argument("--tenants", type=int, default=1,
                   help="number of tenants (SLO classes cycle across them); "
                        "> 1 implies the async tier")
    p.add_argument("--shards", type=int, default=1,
                   help="serve from the sharded full-graph forward over N "
                        "rank processes (gcn/gin; implies the async tier)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="transport of --shards (default: nccl on cuda, "
                        "gloo on cpu; nccl needs one card per shard)")
    p.add_argument("--rate", type=float, default=500.0,
                   help="offered load in req/s for the async tier "
                        "(<= 0 = burst: all requests at t=0)")
    p.add_argument("--stream-deltas", type=int, default=0,
                   help="apply N synthetic interaction-stream deltas to "
                        "the resident graph, interleaved with the request "
                        "replay")
    p.add_argument("--trace-out", default=None,
                   help="write the run's span records as a Chrome/Perfetto "
                        "trace JSON (open in ui.perfetto.dev)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny CI-sized run (overrides --num-nodes, "
                        "--requests, --batch-window, --tune-iters)")
    p.add_argument("--metrics-out", default=None,
                   help="write the run's metrics registry to this path")
    p.add_argument("--metrics-format", default="json",
                   choices=["json", "prom"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.shards < 1:
        p.error("--shards must be >= 1")
    if args.shards > 1 and args.arch not in ("gcn", "gin"):
        p.error("--shards supports gcn/gin only (static edge values)")
    if args.dist_backend == "nccl" and args.device == "cpu":
        p.error("--dist-backend nccl runs on the card only; on the CPU pass "
                "--dist-backend gloo")
    args.use_async = (args.policy in ("deadline", "clock")
                      or args.tenants > 1 or args.slo_ms is not None
                      or args.shards > 1)
    if args.use_async and args.policy == "micro":
        args.policy = "deadline"
    if args.slo_ms is None:
        args.slo_ms = 250.0
    if args.smoke:
        args.num_nodes = 1500
        args.requests = 24
        args.batch_window = 8
        args.tune_iters = 2
        args.verify = min(args.verify, 2)
    if args.batch_window < 1:
        p.error("--batch-window must be >= 1")
    if args.requests < 1:
        p.error("--requests must be >= 1")
    if args.tenants < 1:
        p.error("--tenants must be >= 1")
    if args.slo_ms <= 0:
        p.error("--slo-ms must be > 0")
    if args.stream_deltas < 0:
        p.error("--stream-deltas must be >= 0")
    return args


def _write_metrics(args, registry, tracer) -> None:
    from repro_torch.obs import run_context, write_metrics
    if args.metrics_out:
        write_metrics(registry, args.metrics_out, args.metrics_format,
                      tracer=tracer, context=run_context())
        print(f"[serve_gnn] wrote metrics ({args.metrics_format}) -> "
              f"{args.metrics_out}")


def _write_trace(args, tracer) -> None:
    """--trace-out: span records as a Chrome/Perfetto trace JSON."""
    if not args.trace_out:
        return
    from repro_torch.obs import run_context, write_chrome_trace
    write_chrome_trace(args.trace_out, tracer, context=run_context())
    print(f"[serve_gnn] wrote Chrome trace -> {args.trace_out}")


def _fresh_split_err(sharded_fn, cfg, num_shards: int) -> float:
    """``max|a-b| / (1+|b|)`` of the sharded server's full-graph logits
    against a fresh `Plan.shards` split of its (mutated) plan, run on the
    same rank group."""
    from repro_torch.distributed.graph_shard import make_sharded_logits_fn
    fresh = make_sharded_logits_fn(cfg, sharded_fn.plan.shards(num_shards),
                                   group=sharded_fn.model.group)
    try:
        b = fresh(sharded_fn.params, sharded_fn.feat())
    finally:
        fresh.model.close()
    a = sharded_fn.logits()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def _serve_async(args, g, feat, cfg, registry, tracer, cache=None) -> dict:
    """Replay the trace through the async SLO-aware tier; returns the
    same keys as `run` plus ``async_engine``, ``all_requests``,
    ``accounting``, ``throughput_rps``, ``updates`` and
    ``update_errors`` (``requests`` = the last chunk's)."""
    import dataclasses

    import numpy as np

    from repro_torch.obs import registry_to_json, run_context
    from repro_torch.serving import (AsyncServingEngine, LoadSpec,
                                     ServingEngine, TenantSpec,
                                     build_schedule, run_schedule,
                                     slo_classes)

    t0 = time.time()
    sync = sharded_fn = None
    delta_errs: list = []
    if args.shards > 1:
        from repro_torch.serving import make_sharded_serve_fn
        sharded_fn = make_sharded_serve_fn(
            g, feat, cfg, num_shards=args.shards, tune_iters=args.tune_iters,
            variant=args.variant, dist_backend=args.dist_backend,
            registry=registry)

        def serve_fn(seeds):
            # the sharded path has no engine-internal spans; one span per
            # batch keeps the trace's serve track populated
            with tracer.span("serve_sharded", block=True, batch=len(seeds)):
                return sharded_fn(seeds)

        def update_graph(delta):
            res = sharded_fn.update_graph(delta)
            if args.verify > 0:
                delta_errs.append(_fresh_split_err(sharded_fn, cfg,
                                                   args.shards))
            return res

        serve_fn.update_graph = update_graph
        device = sharded_fn.model.device
    else:
        sync = ServingEngine(g, feat, cfg, serving=_serving_config(args),
                             cache=cache, registry=registry, tracer=tracer)
        serve_fn = sync.serve_batch
        device = sync.device
    # warm the pow-2 batch-size buckets so measured batches replay cached
    # plans instead of paying plan builds
    wrng = np.random.default_rng(args.seed + 1)
    b = 1
    while True:
        serve_fn(wrng.integers(0, g.num_nodes, size=b).tolist())
        if b >= args.batch_window:
            break
        b = min(2 * b, args.batch_window)

    classes = slo_classes(args.slo_ms / 1e3)
    tenants = [TenantSpec(f"t{i}", serve_fn, slo=classes[i % len(classes)],
                          max_batch=args.batch_window)
               for i in range(args.tenants)]
    engine = AsyncServingEngine(tenants, policy=args.policy,
                                window=args.slo_ms / 2e3,
                                registry=registry)
    print(f"[serve_gnn] async tier: policy={args.policy} "
          f"tenants={[(t.name, t.slo.name) for t in tenants]} "
          f"shards={args.shards} backend={args.backend} device={device} "
          f"variant={args.variant} dtype={args.dtype} "
          f"(setup {time.time() - t0:.1f}s)")

    spec = LoadSpec(requests=args.requests,
                    rate_rps=(math.inf if args.rate <= 0 else args.rate),
                    zipf=args.zipf, tenants=tuple(t.name for t in tenants),
                    seed=args.seed)
    schedule = build_schedule(g.num_nodes, spec)
    ok = True
    if args.stream_deltas:
        # interleave graph mutations with the replay: the engine applies
        # each delta between fired batches (no request is dropped), and
        # only the final chunk is eligible for the verify cross-check
        stream = _delta_stream(args, g)
        cuts = np.linspace(0, len(schedule), args.stream_deltas + 2
                           ).astype(int)
        parts, drained, completed, wall = [], True, 0, 0.0
        for ci in range(args.stream_deltas + 1):
            if ci and not engine.update_graph(stream[ci - 1]).wait(60.0):
                print("[serve_gnn] FAIL: graph update not applied")
                ok = False
            # each chunk replays from its own first arrival (the reference
            # replays chunk k from the trace's start, so it first idles
            # through the earlier chunks' span and its wall time, and the
            # throughput, count that idle time)
            chunk = schedule[cuts[ci]:cuts[ci + 1]]
            t_first = chunk[0].t if chunk else 0.0
            part = run_schedule(engine, [dataclasses.replace(a, t=a.t - t_first)
                                         for a in chunk])
            parts.append(part)
            drained = drained and part["drained"]
            completed += part["completed"]
            wall += part["wall_s"]
        reqs = parts[-1]["requests_detail"]
        all_reqs = [r for p in parts for r in p["requests_detail"]]
        res = {"requests": len(all_reqs), "completed": completed,
               "wall_s": wall, "throughput_rps": completed / max(wall, 1e-9),
               "drained": drained}
    else:
        res = run_schedule(engine, schedule)
        reqs = all_reqs = res["requests_detail"]
    updates = int(registry.counter("serve_graph_updates_total").value)
    update_errors = int(
        registry.counter("serve_graph_update_errors_total").value)
    if args.stream_deltas:
        if sharded_fn is not None:
            epoch, n = sharded_fn.plan.epoch, sharded_fn.plan.graph.num_nodes
        else:
            epoch, n = sync.graph_epoch, sync.graph.num_nodes
        print(f"[serve_gnn] applied {args.stream_deltas} deltas "
              f"(updates={updates}, errors={update_errors}, "
              f"graph_epoch={epoch}, n={n})")
        if sharded_fn is not None:
            print(f"[serve_gnn] sub-plans sent again per delta: "
                  f"{[len(r) for r in sharded_fn.resent]} of {args.shards}; "
                  f"vs a fresh split: {delta_errs}")
    acc = engine.accounting()
    summary = engine.summary()
    engine.close()

    doc = registry_to_json(registry, tracer=tracer, context=run_context())
    print(f"[serve_gnn] requests={res['requests']} "
          f"completed={res['completed']} "
          f"throughput={res['throughput_rps']:.1f} req/s")
    for name, st in summary.items():
        print(f"[serve_gnn]   {name} ({st['slo_class']} "
              f"{st['slo_ms']:.0f}ms): p50={st['p50_ms']:.1f}ms "
              f"p99={st['p99_ms']:.1f}ms "
              f"attainment={st['slo_attainment']:.3f} "
              f"mean-batch={st['mean_batch']:.1f}")
    _write_metrics(args, registry, tracer)
    _write_trace(args, tracer)

    ok = ok and res["drained"] and acc["outstanding"] == 0
    ok = ok and acc["submitted"] == acc["completed"] + acc["rejected"]
    ok = ok and updates == args.stream_deltas and update_errors == 0
    tol = 1e-5 if args.dtype == "float32" else 2e-2
    ok = ok and all(e <= tol for e in delta_errs)
    err = None
    if args.verify > 0:
        rng = np.random.default_rng(args.seed)
        done = [r for r in reqs if r.status == "done"]
        err = 0.0
        for i in rng.choice(len(done), size=min(args.verify, len(done)),
                            replace=False):
            single = np.asarray(serve_fn([done[i].seed]))[0]
            err = max(err, float((np.abs(single - done[i].result)
                                  / (1.0 + np.abs(single))).max()))
        ok = ok and err <= tol
        print(f"[serve_gnn] verify: max|batched - single|/(1+|single|) = "
              f"{err:.2e} ({'OK' if err <= tol else 'FAIL'} <= {tol:g})")
    if sharded_fn is not None:
        sharded_fn.close()
    if not ok:
        print(f"[serve_gnn] FAIL: accounting={acc} drained={res['drained']} "
              f"updates={updates} update_errors={update_errors} "
              f"delta_errs={delta_errs}")
    return {"ok": ok, "engine": sync, "sharded_fn": sharded_fn,
            "delta_errs": delta_errs, "async_engine": engine,
            "requests": reqs, "all_requests": all_reqs, "summary": summary,
            "accounting": acc, "throughput_rps": res["throughput_rps"],
            "updates": updates, "update_errors": update_errors,
            "verify_err": err, "doc": doc}


def run(argv=None, *, cache=None) -> dict:
    """Build the engine, replay the trace, verify; returns ``{"ok",
    "engine", "requests", "summary", "verify_err", "doc"}`` (the engine
    stays usable for further checks; the async tier adds the keys
    `_serve_async` names).  ``cache``: an optional shared `PlanCache`
    for the engine (its backend, device and dtype must be the run's)."""
    args = parse_args(argv)

    import numpy as np

    from repro_torch.graphs.csr import random_power_law
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.obs import (MetricsRegistry, SpanTracer,
                                 registry_to_json, run_context)
    from repro_torch.serving import ServingEngine

    t0 = time.time()
    registry = MetricsRegistry()
    tracer = SpanTracer(registry)
    g = random_power_law(args.num_nodes, args.avg_degree, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    feat = rng.standard_normal((g.num_nodes, args.in_dim)).astype(np.float32)
    cfg = GNNConfig(arch=args.arch, in_dim=args.in_dim,
                    hidden_dim=args.hidden_dim, num_classes=args.classes,
                    num_layers=args.layers, backend=args.backend,
                    feat_dtype=args.dtype, device=args.device)
    if args.use_async:
        return _serve_async(args, g, feat, cfg, registry, tracer, cache)

    engine = ServingEngine(g, feat, cfg, serving=_serving_config(args),
                           cache=cache, registry=registry, tracer=tracer)
    print(f"[serve_gnn] graph n={g.num_nodes} e={g.num_edges} arch={args.arch} "
          f"backend={args.backend} device={engine.device} "
          f"variant={args.variant} dtype={args.dtype} hops={engine.hops} "
          f"(setup {time.time() - t0:.1f}s)")

    trace = build_trace(g.num_nodes, args.requests, zipf=args.zipf,
                        seed=args.seed)
    if args.stream_deltas:
        # split the trace into chunks and mutate the resident graph
        # between them; verify only against the final snapshot's chunk
        stream = _delta_stream(args, g)
        cuts = np.linspace(0, len(trace), args.stream_deltas + 2).astype(int)
        for ci in range(args.stream_deltas + 1):
            if ci:
                engine.update_graph(stream[ci - 1])
            reqs = engine.run_trace(list(trace[cuts[ci]:cuts[ci + 1]]))
        print(f"[serve_gnn] applied {args.stream_deltas} deltas "
              f"(graph_epoch={engine.graph_epoch}, "
              f"n={engine.graph.num_nodes}, "
              f"invalidations={engine.cache.stats()['invalidations']})")
    else:
        reqs = engine.run_trace(trace)
    s = engine.summary()
    c = s["cache"]
    doc = registry_to_json(registry, tracer=tracer, context=run_context())
    print(f"[serve_gnn] requests={s['requests']} "
          f"throughput={s['req_per_s']:.1f} req/s "
          f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
          f"hit-rate={c['hit_rate']:.2f}")
    _write_metrics(args, registry, tracer)
    _write_trace(args, tracer)

    ok, err = True, None
    if args.verify > 0:
        pick = rng.choice(len(reqs), size=min(args.verify, len(reqs)),
                          replace=False)
        err = 0.0
        for i in pick:
            single = engine.serve_batch([reqs[i].seed])[0]
            # magnitude-normalized: GIN logits grow with degree sums
            err = max(err, float((np.abs(single - reqs[i].result)
                                  / (1.0 + np.abs(single))).max()))
        # bf16 activations round per layer, so two paddings of the same ego
        # can differ by a few ulps (~1e-2 relative); f32 stays at 1e-5
        tol = 1e-5 if args.dtype == "float32" else 2e-2
        ok = err <= tol
        print(f"[serve_gnn] verify: max|batched - single|/(1+|single|) = "
              f"{err:.2e} ({'OK' if ok else 'FAIL'} <= {tol:g})")
    if c["hit_rate"] <= 0:
        print("[serve_gnn] WARNING: plan-cache hit rate is 0")
        # streamed deltas bump the epoch key, legitimately resetting reuse
        if args.requests >= 4 * args.batch_window and not args.stream_deltas:
            ok = False
    return {"ok": ok, "engine": engine, "requests": reqs, "summary": s,
            "verify_err": err, "doc": doc}


def main(argv=None) -> int:
    res = run(argv)
    print(json.dumps(res["doc"], indent=2))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
