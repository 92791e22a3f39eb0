"""Helpers of the benchmark's CPU tests: a cell run on the CPU, through
the port's plain backend, on a replica cut to a few hundred nodes."""
import time

from perfbench import harness

TRAIN = ["gcn-reddit.train", "gin-reddit.train"]
INFER = ["gcn-reddit.infer", "gin-reddit.infer"]
SEED = 2**31 + 11        # larger than 32 signed bits hold, as run seeds may be


def nodes(workload: str, control: bool = False) -> int:
    """GCN's narrow layers are cheap on the CPU; its TF32 control needs
    about 5,000 nodes to separate from float32 by the card's limits.
    GIN's 602-column aggregation keeps to 400."""
    if workload.startswith("gcn"):
        return 5000 if control else 2000
    return 400


def run_small(workload, *, seed=SEED, trace=False, bench=None, **kw):
    return harness.run_cell(bench or harness.load_benchmark(), workload,
                            seed=seed, seconds=0.05, trace=trace,
                            t0=time.perf_counter(), device="cpu",
                            backend="torch", num_nodes=nodes(workload),
                            cache_dir=None, **kw)
