"""GNN serving driver: replay a synthetic node-prediction request trace.

Port of `src/repro/launch/serve_gnn.py`, the synchronous micro-batcher
path (``--policy micro``):

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn \
        --num-nodes 20000 --requests 256 --batch-window 16

    # on a machine without a card: the plain PyTorch versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --smoke \
        --device cpu --backend torch

Builds a power-law resident graph, initializes a GCN/GIN/GAT, then replays
a Zipf-popularity request trace through `ServingEngine` and prints
requests/s, p50/p99 latency and the plan-cache hit rate, then the JSON
metrics document.  ``--verify N`` re-serves N requests alone and checks
``max|batched - single| / (1 + |single|)`` against 1e-5 (float32) or
2e-2 (bfloat16); exit code 1 on failure.

Port flags beside the reference's: ``--device cuda|cpu`` (default cuda;
raises without CUDA), ``--backend cuda|torch`` (hand-written kernels or
plain PyTorch) and ``--variant folded|slot_onehot|direct`` (the gather
kernel).  The async tier, ``--shards``, ``--stream-deltas`` and
``--trace-out`` wait for their slices.
"""
from __future__ import annotations

import argparse
import json
import time


def build_trace(num_nodes: int, requests: int, *, zipf: float = 1.1,
                hot_fraction: float = 0.05, seed: int = 0):
    """Power-law seed popularity (`serving.loadgen.zipf_seeds`)."""
    from repro_torch.serving.loadgen import zipf_seeds
    return zipf_seeds(num_nodes, requests, zipf=zipf,
                      hot_fraction=hot_fraction, seed=seed)


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
    p.add_argument("--smoke", action="store_true",
                   help="tiny CI-sized run (overrides --num-nodes, "
                        "--requests, --batch-window, --tune-iters)")
    p.add_argument("--metrics-out", default=None,
                   help="write the run's metrics registry to this path")
    p.add_argument("--metrics-format", default="json",
                   choices=["json", "prom"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
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
    return args


def run(argv=None) -> dict:
    """Build the engine, replay the trace, verify; returns ``{"ok",
    "engine", "requests", "summary", "verify_err", "doc"}`` (the engine
    stays usable for further checks)."""
    args = parse_args(argv)

    import numpy as np

    from repro_torch.graphs.csr import random_power_law
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.obs import (MetricsRegistry, SpanTracer,
                                 registry_to_json, run_context, write_metrics)
    from repro_torch.serving import ServingConfig, ServingEngine

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
    engine = ServingEngine(
        g, feat, cfg,
        serving=ServingConfig(hops=args.hops, max_batch=args.batch_window,
                              batch_mode=args.batch_mode,
                              bucket_shapes=args.bucket,
                              tune_iters=args.tune_iters,
                              max_plans=(None if args.max_plans == 0
                                         else args.max_plans),
                              variant=args.variant),
        registry=registry, tracer=tracer)
    print(f"[serve_gnn] graph n={g.num_nodes} e={g.num_edges} arch={args.arch} "
          f"backend={args.backend} device={engine.device} "
          f"variant={args.variant} dtype={args.dtype} hops={engine.hops} "
          f"(setup {time.time() - t0:.1f}s)")

    trace = build_trace(g.num_nodes, args.requests, zipf=args.zipf,
                        seed=args.seed)
    reqs = engine.run_trace(trace)
    s = engine.summary()
    c = s["cache"]
    doc = registry_to_json(registry, tracer=tracer, context=run_context())
    print(f"[serve_gnn] requests={s['requests']} "
          f"throughput={s['req_per_s']:.1f} req/s "
          f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
          f"hit-rate={c['hit_rate']:.2f}")
    if args.metrics_out:
        write_metrics(registry, args.metrics_out, args.metrics_format,
                      tracer=tracer, context=run_context())
        print(f"[serve_gnn] wrote metrics ({args.metrics_format}) -> "
              f"{args.metrics_out}")

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
        if args.requests >= 4 * args.batch_window:
            ok = False
    return {"ok": ok, "engine": engine, "requests": reqs, "summary": s,
            "verify_err": err, "doc": doc}


def main(argv=None) -> int:
    res = run(argv)
    print(json.dumps(res["doc"], indent=2))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
