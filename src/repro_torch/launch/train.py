"""Training driver: GNN node classification, full-graph or sampled.

Port of the GNN branches of `src/repro/launch/train.py`.  Full-graph
(`_main_gnn`): a paper-dataset replica -> advisor plan with the forward
and transposed backward schedules -> the gradient through the chosen
backend -> AdamW -> the fault-tolerant `Trainer` loop.  ``--sampled``
(`_main_gnn_sampled`): per-step fanout-sampled bipartite blocks planned
through a train-ready plan cache by a prefetching loader
(`repro_torch.sampling`), so per-step memory is bounded by the batch, not
the graph: full-size Type III graphs train where full-batch cannot.

    # on the card: forward, feature backward and GAT's edge-value gradient
    # all run the hand-written CUDA kernels
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat \
        --dataset pubmed --max-nodes 19717 --variant direct

    # without a card: the plain PyTorch versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn \
        --dataset cora --steps 20 --device cpu --backend torch

    # sampled training on the full reddit replica, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn --sampled \
        --dataset reddit --scale 1.0 --fanouts 10,5 --batch-nodes 512

    # ... with an interaction-stream delta (1% of the edges) swapped into
    # the loader's resident graph every 4 steps
    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn --sampled \
        --dataset reddit --stream-deltas 4

Full-graph labels come from a frozen random teacher of the same
architecture (`models.gnn.planted_labels`), so the task is learnable and
the loss falls; sampled runs use `structural_labels` (no full-graph
teacher forward: that is the pass sampling exists to avoid).  Port flags
beside the reference's: ``--device cuda|cpu`` (default cuda; raises
without CUDA), ``--backend cuda|torch`` (hand-written kernels or plain
PyTorch) and ``--variant folded|slot_onehot|direct`` (the gather kernel).
``--stream-deltas`` requires ``--sampled``, as in the reference.
``--trace-out PATH`` (both branches) writes the Trainer's span records
(``train`` / ``train/step`` / ``train/step/batch`` /
``train/checkpoint``) as a Chrome/Perfetto trace with `run_context()` in
``otherData``.
``--shards`` and the LM architectures wait for their slices and exit with
an error naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

GNN_ARCHS = ("gcn", "gin", "gat")


class _DeltaStream:
    """Wrap a batch_fn: before step ``k*every`` is served, apply the next
    `interaction_stream` delta to the loader.  The swap happens at the
    loader's safe batch boundary; mutated steps resample from the new
    snapshot.  Restart-safe: a replayed step does not re-apply its delta
    (the mutation stream is consumed at most once per step)."""

    def __init__(self, batch_fn, loader, stream, every: int):
        self.batch_fn = batch_fn
        self.loader = loader
        self.stream = stream
        self.every = every
        self.applied_at: list = []      # steps whose delta was applied
        self._seen: set = set()

    @property
    def applied(self) -> int:
        return len(self.applied_at)

    def __call__(self, step: int):
        if step and step % self.every == 0 and step not in self._seen:
            self._seen.add(step)
            delta = next(self.stream, None)
            if delta is not None:
                self.loader.update_graph(delta)
                self.applied_at.append(step)
        return self.batch_fn(step)

    def close(self):
        close = getattr(self.batch_fn, "close", None)
        (close or self.loader.close)()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                   help="cuda = hand-written kernels, torch = plain PyTorch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--variant", default="folded",
                   choices=["folded", "slot_onehot", "direct"],
                   help="gather kernel of the plan (forward, feature "
                        "backward and edge-value gradient)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="feature/activation dtype policy (parameters and "
                        "accumulation stay float32)")
    p.add_argument("--dataset", default="cora",
                   help="paper-dataset replica")
    p.add_argument("--max-nodes", type=int, default=None,
                   help="cap the dataset's node count (default: 2000 "
                        "full-graph, uncapped with --sampled)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="dataset size multiplier (1.0 = paper size)")
    p.add_argument("--hidden-dim", type=int, default=32)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (default: one under the "
                        "temporary directory keyed on the run's flags; the "
                        "trainer resumes from the newest checkpoint there)")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--fail-at", type=int, action="append", default=None,
                   help="inject a simulated failure at this step (repeatable)")
    p.add_argument("--metrics-out", default=None,
                   help="write the run's metrics registry to this path")
    p.add_argument("--metrics-format", default="json",
                   choices=["json", "prom"])
    p.add_argument("--trace-out", default=None,
                   help="write the Trainer's span records as a Chrome/"
                        "Perfetto trace JSON (open in ui.perfetto.dev)")
    p.add_argument("--sampled", action="store_true",
                   help="neighbor-sampled mini-batch training (gcn/gin)")
    p.add_argument("--fanouts", default="10,5",
                   help="comma-separated per-layer fanouts (with --sampled)")
    p.add_argument("--batch-nodes", type=int, default=512,
                   help="seed nodes per sampled mini-batch")
    p.add_argument("--shards", type=int, default=1,
                   help="graph shards (not ported: 1 only)")
    p.add_argument("--stream-deltas", type=int, default=0,
                   help="with --sampled: apply one synthetic interaction-"
                        "stream delta to the resident graph every N steps")
    p.add_argument("--stream-edges", type=int, default=0,
                   help="edges per streamed delta (default ~1%% of the "
                        "seed graph's edges)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.arch not in GNN_ARCHS:
        p.error(f"--arch {args.arch}: only {GNN_ARCHS} are ported; the LM "
                f"architectures wait for the LM slices (ROADMAP.md Queue 1, "
                f"items 2 and 9)")
    if args.sampled and args.arch not in ("gcn", "gin"):
        p.error("--sampled supports gcn/gin only (the reference refuses "
                "GAT too)")
    if args.stream_deltas < 0 or args.stream_edges < 0:
        p.error("--stream-deltas and --stream-edges must be >= 0")
    if args.stream_deltas and not args.sampled:
        p.error("--stream-deltas requires --sampled (the resident-graph "
                "loader owns the swap protocol)")
    if args.shards != 1:
        p.error("--shards is not ported yet (ROADMAP.md Queue 1, item 5: "
                "sharding)")
    if args.steps < 0:
        p.error("--steps must be >= 0")
    return args


def _train(args, step_fn, batch_fn, state, ckpt_dir, registry,
           tracer) -> dict:
    """The Trainer loop of both branches: ``args.steps`` steps from
    ``state`` (resuming from ``ckpt_dir``, failures injected at
    ``--fail-at``), the batch source closed after, ``--metrics-out`` and
    ``--trace-out`` written.  Returns ``{"ok", "trainer", "history",
    "first_loss", "last_loss", "avg_step_s", "wall_s", "doc"}``."""
    import numpy as np

    from repro_torch.obs import (registry_to_json, run_context,
                                 write_chrome_trace, write_metrics)
    from repro_torch.runtime.trainer import (FailureInjector, Trainer,
                                             TrainerConfig)

    trainer = Trainer(
        TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
                      log_every=10),
        step_fn, batch_fn, state,
        injector=FailureInjector(args.fail_at or ()), registry=registry,
        tracer=tracer)
    t0 = time.time()
    try:
        trainer.run(args.steps)
    finally:
        trainer.close()
    wall = time.time() - t0
    hist = trainer.metrics_history
    if args.metrics_out:
        write_metrics(registry, args.metrics_out, args.metrics_format,
                      tracer=tracer, context=run_context())
        print(f"[train] wrote metrics ({args.metrics_format}) -> "
              f"{args.metrics_out}")
    if args.trace_out:
        write_chrome_trace(args.trace_out, tracer, context=run_context())
        print(f"[train] wrote Chrome trace -> {args.trace_out}")
    return {"ok": all(np.isfinite(m["loss"]) for m in hist),
            "trainer": trainer, "history": hist,
            "first_loss": hist[0]["loss"] if hist else float("nan"),
            "last_loss": hist[-1]["loss"] if hist else float("nan"),
            "avg_step_s": trainer.avg_step_time(), "wall_s": wall,
            "doc": registry_to_json(registry, tracer=tracer,
                                    context=run_context())}


@functools.lru_cache(maxsize=1)
def _sampled_dataset(name: str, scale: float, max_nodes, seed: int):
    """The sampled branch's replica at ``max_dim=128`` with its structural
    labels, kept for the next run in this process (full reddit takes
    about a minute to generate; callers do not mutate it)."""
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.models.gnn import structural_labels

    g, spec, feat = make_dataset(name, scale=scale, max_nodes=max_nodes,
                                 seed=seed, max_dim=128)
    return g, spec, feat, structural_labels(g, spec.num_classes)


def run(argv=None) -> dict:
    """Build the model, train, report; returns ``{"ok", "model", "trainer",
    "batch", "init_params", "history", "first_loss", "last_loss",
    "avg_step_s", "doc"}`` (``init_params`` is a copy of the parameters the
    run started from, for cross-checks).  With ``--sampled`` see
    `_run_sampled`."""
    args = parse_args(argv)
    if args.sampled:
        return _run_sampled(args)

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.models.gnn import (GNNConfig, build_gnn,
                                        make_gnn_train_step, planted_labels)
    from repro_torch.obs import MetricsRegistry, SpanTracer
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)

    device = resolve_device(args.device)      # raises without a card
    registry = MetricsRegistry()
    tracer = SpanTracer(registry)
    t0 = time.time()
    max_nodes = 2000 if args.max_nodes is None else args.max_nodes
    g, spec, feat = make_dataset(args.dataset, scale=args.scale,
                                 max_nodes=max_nodes, seed=args.seed)
    in_dim = min(spec.dim, 128)
    feat = feat[:, :in_dim].astype(np.float32)
    cfg = GNNConfig(arch=args.arch, in_dim=in_dim,
                    hidden_dim=args.hidden_dim,
                    num_classes=spec.num_classes, num_layers=2,
                    backend=args.backend, feat_dtype=args.dtype,
                    device=str(device))
    # learnable planted task: labels from a frozen random teacher
    labels = planted_labels(g, cfg, feat, seed=args.seed + 7)
    model = build_gnn(g, cfg, generator=torch.Generator().manual_seed(
        args.seed), reorder="auto", tune_iters=6, seed=args.seed,
        variant=args.variant)
    plan = model.plan
    batch = {"feat": torch.as_tensor(plan.renumber_features(feat),
                                     device=device),
             "labels": torch.as_tensor(plan.renumber_features(labels),
                                       dtype=torch.int64, device=device)}
    c = plan.config
    print(f"[train] dataset={args.dataset} N={g.num_nodes} E={g.num_edges} "
          f"in_dim={in_dim} classes={spec.num_classes} arch={args.arch} "
          f"backend={args.backend} device={device} variant={c.variant} "
          f"dtype={args.dtype} gs={c.gs} gpt={c.gpt} dt={c.dt} "
          f"src_win={c.src_win} tiles={plan.partition.num_tiles}/"
          f"{plan.partition_bwd.num_tiles if plan.partition_bwd else '-'} "
          f"(setup {time.time() - t0:.1f}s)", flush=True)

    opt = AdamWConfig(lr=args.lr,
                      schedule=cosine_schedule(args.warmup, args.steps))
    step_fn = make_gnn_train_step(model, opt)
    # the parameter shapes and the graph both depend on these flags; a run
    # under another configuration must not resume this one's checkpoint
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(),
        f"repro_torch_train_{args.arch}_{args.dataset}_n{max_nodes}"
        f"_s{args.scale}_h{args.hidden_dim}_{args.backend}_{args.dtype}"
        f"_{args.variant}_{args.seed}")
    init_params = {k: v.detach().clone() for k, v in model.params.items()}
    res = _train(args, step_fn, lambda step: batch,
                 (model.params, adamw_init(model.params)), ckpt_dir,
                 registry, tracer)
    print(f"[train] arch={args.arch} backend={args.backend} "
          f"dtype={args.dtype} variant={c.variant} dataset={args.dataset} "
          f"steps={len(res['history'])} first_loss={res['first_loss']:.4f} "
          f"last_loss={res['last_loss']:.4f} "
          f"avg_step={res['avg_step_s'] * 1e3:.2f}ms "
          f"wall={res['wall_s']:.1f}s", flush=True)
    return dict(res, model=model, batch=batch, init_params=init_params)


def _run_sampled(args) -> dict:
    """Neighbor-sampled branch (the reference's `_main_gnn_sampled`):
    fanout sampler -> per-block train-ready plan cache -> eager step on
    the entries' executors -> fault-tolerant Trainer loop.  Returns
    ``{"ok", "cfg", "loader", "step_fn", "trainer", "init_params",
    "history", "first_loss", "last_loss", "avg_step_s", "stats", "doc",
    "stream"}`` (``stats`` is the loader's, with ``num_buckets``;
    ``stream`` the `_DeltaStream` under ``--stream-deltas``, else None)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models.gnn import GNNConfig, init_gnn_params
    from repro_torch.obs import MetricsRegistry, SpanTracer
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)
    from repro_torch.sampling import (LoaderConfig, SampledLoader,
                                      SampledTrainStep)

    device = resolve_device(args.device)      # raises without a card
    registry = MetricsRegistry()
    tracer = SpanTracer(registry)
    t0 = time.time()
    g, spec, feat, labels = _sampled_dataset(args.dataset, args.scale,
                                             args.max_nodes, args.seed)
    in_dim = feat.shape[1]
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    cfg = GNNConfig(arch=args.arch, in_dim=in_dim,
                    hidden_dim=args.hidden_dim,
                    num_classes=spec.num_classes, num_layers=len(fanouts),
                    backend=args.backend, feat_dtype=args.dtype,
                    device=str(device))
    print(f"[train] sampled dataset={args.dataset} scale={args.scale} "
          f"N={g.num_nodes} E={g.num_edges} in_dim={in_dim} "
          f"classes={spec.num_classes} arch={args.arch} "
          f"backend={args.backend} device={device} variant={args.variant} "
          f"dtype={args.dtype} (gen {time.time() - t0:.1f}s)", flush=True)
    loader = SampledLoader(
        g, feat, labels, cfg,
        LoaderConfig(fanouts=fanouts, batch_nodes=args.batch_nodes,
                     seed=args.seed, variant=args.variant),
        registry=registry)
    opt = AdamWConfig(lr=args.lr,
                      schedule=cosine_schedule(args.warmup, args.steps))
    step_fn = SampledTrainStep(cfg, opt)
    batch_fn, stream = loader, None
    if args.stream_deltas:
        from repro_torch.graphs.datasets import interaction_stream
        eb = args.stream_edges or max(32, g.num_edges // 100)
        batch_fn = stream = _DeltaStream(
            loader, loader,
            interaction_stream(g, num_batches=args.steps // args.stream_deltas
                               + 1, edges_per_batch=eb, feat_dim=in_dim,
                               seed=args.seed),
            args.stream_deltas)
        print(f"[train] streaming deltas: every {args.stream_deltas} steps, "
              f"{eb} edges/batch", flush=True)
    params = init_gnn_params(cfg, torch.Generator().manual_seed(args.seed))
    init_params = {k: v.detach().clone() for k, v in params.items()}
    # the parameter shapes and the batch stream both depend on these flags
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(),
        f"repro_torch_train_sampled_{args.arch}_{args.dataset}"
        f"_n{args.max_nodes}_s{args.scale}_h{args.hidden_dim}"
        f"_f{'-'.join(map(str, fanouts))}_b{args.batch_nodes}"
        f"_d{args.stream_deltas}x{args.stream_edges}"
        f"_{args.backend}_{args.dtype}_{args.variant}_{args.seed}")
    res = _train(args, step_fn, batch_fn, (params, adamw_init(params)),
                 ckpt_dir, registry, tracer)
    st = dict(loader.stats(), num_buckets=step_fn.num_buckets)
    deltas = (f"graph_epoch={st['graph_epoch']} "
              if st["graph_swaps"] else "")
    print(f"[train] arch={args.arch} backend={args.backend} "
          f"dtype={args.dtype} variant={args.variant} sampled "
          f"fanouts={fanouts} batch={args.batch_nodes} "
          f"steps={len(res['history'])} first_loss={res['first_loss']:.4f} "
          f"last_loss={res['last_loss']:.4f} {deltas}"
          f"avg_step={res['avg_step_s'] * 1e3:.2f}ms "
          f"buckets={step_fn.num_buckets} "
          f"cache_hit_rate={st['cache']['hit_rate']:.2f} "
          f"sample_p50={st['sample_p50_ms']:.1f}ms "
          f"stall_p99={st['prefetch_stall_p99_ms']:.1f}ms "
          f"wall={res['wall_s']:.1f}s", flush=True)
    return dict(res, cfg=cfg, loader=loader, step_fn=step_fn,
                init_params=init_params, stats=st, stream=stream)


def main(argv=None) -> int:
    res = run(argv)
    print(json.dumps({k: res[k] for k in ("ok", "first_loss", "last_loss",
                                          "avg_step_s")}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
