"""Training driver: full-graph GNN node classification.

Port of the full-graph GNN branch of `src/repro/launch/train.py`
(`_main_gnn`): a paper-dataset replica -> advisor plan with the forward and
transposed backward schedules -> ``loss.backward()`` through the chosen
backend -> AdamW -> the fault-tolerant `Trainer` loop.

    # on the card: forward, feature backward and GAT's edge-value gradient
    # all run the hand-written CUDA kernels
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat \
        --dataset pubmed --max-nodes 19717 --variant direct

    # without a card: the plain PyTorch versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn \
        --dataset cora --steps 20 --device cpu --backend torch

Labels come from a frozen random teacher of the same architecture
(`models.gnn.planted_labels`), so the task is learnable and the loss
falls.  Port flags beside the reference's: ``--device cuda|cpu`` (default
cuda; raises without CUDA), ``--backend cuda|torch`` (hand-written
kernels or plain PyTorch) and ``--variant folded|slot_onehot|direct``
(the gather kernel).  ``--sampled``, ``--shards`` and the LM
architectures wait for their slices and exit with an error naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

GNN_ARCHS = ("gcn", "gin", "gat")


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
    p.add_argument("--max-nodes", type=int, default=2000,
                   help="cap the dataset's node count")
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
    p.add_argument("--sampled", action="store_true",
                   help="neighbor-sampled mini-batch training (not ported)")
    p.add_argument("--shards", type=int, default=1,
                   help="graph shards (not ported: 1 only)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.arch not in GNN_ARCHS:
        p.error(f"--arch {args.arch}: only {GNN_ARCHS} are ported; the LM "
                f"architectures wait for the LM slices (ROADMAP.md Queue 1, "
                f"items 2 and 9)")
    if args.sampled:
        p.error("--sampled is not ported yet (ROADMAP.md Queue 1, item 3: "
                "sampled training)")
    if args.shards != 1:
        p.error("--shards is not ported yet (ROADMAP.md Queue 1, item 5: "
                "sharding)")
    if args.steps < 0:
        p.error("--steps must be >= 0")
    return args


def run(argv=None) -> dict:
    """Build the model, train, report; returns ``{"ok", "model", "trainer",
    "batch", "init_params", "history", "first_loss", "last_loss",
    "avg_step_s", "doc"}`` (``init_params`` is a copy of the parameters the
    run started from, for cross-checks)."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.models.gnn import (GNNConfig, build_gnn,
                                        make_gnn_train_step, planted_labels)
    from repro_torch.obs import (MetricsRegistry, SpanTracer,
                                 registry_to_json, run_context, write_metrics)
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)
    from repro_torch.runtime.trainer import (FailureInjector, Trainer,
                                             TrainerConfig)

    device = resolve_device(args.device)      # raises without a card
    registry = MetricsRegistry()
    tracer = SpanTracer(registry)
    t0 = time.time()
    g, spec, feat = make_dataset(args.dataset, scale=args.scale,
                                 max_nodes=args.max_nodes, seed=args.seed)
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
        f"repro_torch_train_{args.arch}_{args.dataset}_n{args.max_nodes}"
        f"_s{args.scale}_h{args.hidden_dim}_{args.backend}_{args.dtype}"
        f"_{args.variant}_{args.seed}")
    init_params = {k: v.detach().clone() for k, v in model.params.items()}
    trainer = Trainer(
        TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
                      log_every=10),
        step_fn, lambda step: batch,
        (model.params, adamw_init(model.params)),
        injector=FailureInjector(args.fail_at or ()), registry=registry,
        tracer=tracer)
    t1 = time.time()
    try:
        trainer.run(args.steps)
    finally:
        trainer.close()
    hist = trainer.metrics_history
    first = hist[0]["loss"] if hist else float("nan")
    last = hist[-1]["loss"] if hist else float("nan")
    avg = trainer.avg_step_time()
    print(f"[train] arch={args.arch} backend={args.backend} "
          f"dtype={args.dtype} variant={c.variant} dataset={args.dataset} "
          f"steps={len(hist)} first_loss={first:.4f} last_loss={last:.4f} "
          f"avg_step={avg * 1e3:.2f}ms wall={time.time() - t1:.1f}s",
          flush=True)
    doc = registry_to_json(registry, tracer=tracer, context=run_context())
    if args.metrics_out:
        write_metrics(registry, args.metrics_out, args.metrics_format,
                      tracer=tracer, context=run_context())
        print(f"[train] wrote metrics ({args.metrics_format}) -> "
              f"{args.metrics_out}")
    ok = all(np.isfinite(m["loss"]) for m in hist)
    return {"ok": ok, "model": model, "trainer": trainer, "batch": batch,
            "init_params": init_params, "history": hist,
            "first_loss": first, "last_loss": last, "avg_step_s": avg,
            "doc": doc}


def main(argv=None) -> int:
    res = run(argv)
    print(json.dumps({k: res[k] for k in ("ok", "first_loss", "last_loss",
                                          "avg_step_s")}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
