"""Where a sampled batch's host build goes: `SampledLoader.batch_for`
timed and profiled on a paper-dataset replica.

    PYTHONPATH=src python tools/sampled_loader_profile.py --dataset reddit \
        --scale 0.1 --device cpu
    # on a machine with a card (the schedules upload there)
    PYTHONPATH=src python tools/sampled_loader_profile.py --dataset reddit

Builds one batch to warm the plan cache's config memo, then ``--batches``
more (no prefetch thread) and prints the median build time, the blocks'
raw sizes and tile counts, and the ``--top`` functions by their own time
under `cProfile` (which adds cost to every Python call, not to work inside
numpy: read the shares, not the totals).  Imports only the port.
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import statistics
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--arch", default="gcn", choices=["gcn", "gin"])
    ap.add_argument("--fanouts", default="10,5")
    ap.add_argument("--batch-nodes", type=int, default=512)
    ap.add_argument("--hidden-dim", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["cuda", "torch"],
                    help="default: cuda on the card, torch on the CPU")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.models.gnn import GNNConfig, structural_labels
    from repro_torch.sampling import LoaderConfig, SampledLoader

    backend = args.backend or ("cuda" if args.device == "cuda" else "torch")
    t0 = time.perf_counter()
    g, spec, feat = make_dataset(args.dataset, scale=args.scale, seed=0,
                                 max_dim=128)
    labels = structural_labels(g, spec.num_classes)
    print(f"{args.dataset} scale={args.scale} N={g.num_nodes} "
          f"E={g.num_edges} (generated in {time.perf_counter() - t0:.1f}s)")
    fanouts = tuple(int(f) for f in args.fanouts.split(","))
    cfg = GNNConfig(arch=args.arch, in_dim=feat.shape[1],
                    hidden_dim=args.hidden_dim,
                    num_classes=spec.num_classes, num_layers=len(fanouts),
                    backend=backend, device=args.device)
    loader = SampledLoader(
        g, feat, labels, cfg,
        LoaderConfig(fanouts=fanouts, batch_nodes=args.batch_nodes),
        start_thread=False, with_backward=True)
    loader.batch_for(0)
    times = []
    prof = cProfile.Profile()
    for step in range(1, args.batches + 1):
        t1 = time.perf_counter()
        prof.enable()
        b = loader.batch_for(step)
        prof.disable()
        times.append(time.perf_counter() - t1)
        tiles = [(e.plan.partition.num_tiles, e.plan.partition_bwd.num_tiles)
                 for e in b.entries]
        print(f"step {step}: {1e3 * times[-1]:.1f} ms, raw nodes "
              f"{b.raw_nodes}, edges {b.raw_edges}, tiles fwd/bwd {tiles}")
    print(f"median build {1e3 * statistics.median(times):.1f} ms over "
          f"{len(times)} batches ({args.device}, backend {backend})")
    pstats.Stats(prof).sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
