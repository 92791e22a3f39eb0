"""A configuration, a traffic mix, a per-layer metric, a cell and an
architecture added as new files and entries are found by name, with no
existing file edited."""
import json
import shutil
import textwrap

import numpy as np

from perfbench import harness
from perfbench._testing import run_small
from perfbench.graph import Graph
from perfbench.inputs import make_inputs
from perfbench.metrics import _work


def test_added_files_are_picked_up(tmp_path):
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(harness.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}

    cfg = json.loads((bench_dir / "configs" / "gcn-reddit.json").read_text())
    cfg["model"]["hidden_dim"] = 32
    (bench_dir / "configs" / "gcn-wide.json").write_text(json.dumps(cfg))
    (bench_dir / "mixes" / "infer-brief.json").write_text(json.dumps(
        {"kind": "infer", "warmup_requests": 1, "sampled_requests": 2,
         "trace_seconds": 0.01}))
    (bench_dir / "metrics" / "requests_traced.py").write_text(
        "def read(run):\n    return run.trace.units\n")
    (bench_dir / "limits" / "gcn-wide.infer-brief.json").write_text(
        json.dumps({"logit_gap": 1e-4, "argmax_gap": 1e-4}))

    bench = harness.load_benchmark()
    bench["configs"].append({"name": "gcn-wide", "source": "test",
                             "file": "perfbench/configs/gcn-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gcn-wide.infer-brief",
                               "config": "gcn-wide", "traffic": "infer-brief",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_traced", "unit": "req",
                               "better": "higher", "source": "device_trace",
                               "layer": "test", "moves": "infer_ms",
                               "workloads": ["gcn-wide.infer-brief"]})
    out = run_small("gcn-wide.infer-brief", bench=bench, bench_dir=bench_dir,
                    trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_traced"]["value"] >= 1
    assert all(p.read_bytes() == b for p, b in before.items())


def test_metric_split_by_suffix_takes_its_base_readers():
    for m in harness.load_benchmark()["per_layer"]:
        reader = harness.reader_of(m["name"])
        assert callable(reader.read), m["name"]
    assert not (harness.BENCH_DIR / "metrics" / "agg_ms.train.py").exists()


def test_added_architecture_is_picked_up(tmp_path):
    bench_dir = tmp_path / "perfbench"
    (bench_dir / "arch").mkdir(parents=True)
    (bench_dir / "arch" / "lin.py").write_text(textwrap.dedent("""\
        SELF_LOOPS = False
        WEIGHTED = False

        def param_shapes(model):
            return [("w0", (model["in_dim"], model["num_classes"]), True)]

        def agg_widths(model, kind):
            return [model["in_dim"]]

        def products(model):
            return [(model["in_dim"], model["num_classes"], False)]
        """))
    arch = harness.load_arch("lin", bench_dir)
    model = dict(arch="lin", in_dim=3, num_classes=2, feat_dtype="float32")
    g = Graph(np.array([0, 1, 2]), np.array([1, 0]))
    calls = _work.agg_calls(arch, model, g, "infer")
    assert [(c.width, c.edges, c.sources, c.weighted) for c in calls] == \
        [(3, 2, 2, False)]
    # the product forward and its dW (2 x 2 nodes x 3 x 2 each), and one
    # unweighted aggregation at width 3 over 2 edges
    assert _work.model_flops(arch, model, g, "train") == 24 + 24 + 6
    config = {"model": model, "train_fraction": 0.5,
              "init": {"first_matrix_degree_power": 0.0}}
    inp = make_inputs(arch, config, 5, g.num_nodes, 1.0, "cpu")
    assert inp["params"]["w0"].shape == (3, 2)
