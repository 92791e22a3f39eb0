"""The counts of work behind `agg_roofline.*` and `mfu.*`, on small
graphs worked by hand."""
import numpy as np
import pytest

from perfbench import harness
from perfbench.graph import Graph
from perfbench.metrics import _peaks, _work

# path 0 - 1 - 2, both directions: 4 edges; node 3 isolated in GIN's
PATH3 = Graph(np.array([0, 1, 3, 4]), np.array([1, 0, 2, 1]))
PATH4 = Graph(np.array([0, 1, 3, 4, 4]), np.array([1, 0, 2, 1]))
GCN = dict(arch="gcn", in_dim=5, hidden_dim=2, num_classes=3, num_layers=2,
           gin_eps=0.0, feat_dtype="float32")
GIN = dict(GCN, arch="gin")
ARCH = {"gcn": harness.load_arch("gcn"), "gin": harness.load_arch("gin")}


def calls_of(model, graph, kind):
    return _work.agg_calls(ARCH[model["arch"]], model, graph, kind)


def test_gcn_calls_bytes_flops():
    calls = calls_of(GCN, PATH3, "infer")
    assert [(c.width, c.edges, c.sources, c.weighted) for c in calls] == \
        [(2, 7, 3, True), (3, 7, 3, True)]
    # 7 edges x 8 B + indptr 4 x 8 B + rows read and written
    assert [_work.call_bytes(c) for c in calls] == [136, 160]
    assert [_work.call_flops(c) for c in calls] == [28, 42]
    assert len(calls_of(GCN, PATH3, "train")) == 4


def test_gin_calls_bytes_flops():
    calls = calls_of(GIN, PATH4, "infer")
    assert [(c.width, c.edges, c.sources, c.weighted) for c in calls] == \
        [(5, 4, 3, False), (2, 4, 3, False)]
    # ids only (4 B an edge), indptr 5 x 8 B, 3 source rows, 4 output rows
    assert [_work.call_bytes(c) for c in calls] == [196, 112]
    assert [_work.call_flops(c) for c in calls] == [20, 8]
    # layer 0 aggregates the constant features: no backward call
    assert [c.width for c in calls_of(GIN, PATH4, "train")] == [5, 2, 2]


@pytest.mark.parametrize("model,graph,kind,flops", [
    (GCN, PATH3, "infer", 96 + 70),
    # dW of both products, dX of the second only
    (GCN, PATH3, "train", 96 + 60 + 72 + 140),
    (GIN, PATH4, "infer", 192 + 28),
    (GIN, PATH4, "train", 192 + 80 + 64 + 64 + 96 + 36),
])
def test_model_flops(model, graph, kind, flops):
    assert _work.model_flops(ARCH[model["arch"]], model, graph, kind) == flops


def test_least_seconds_takes_the_larger_bound():
    calls = calls_of(GCN, PATH3, "infer")
    want = sum(max(b / _peaks.HBM_BYTES_PER_S, f / _peaks.F32_FLOP_PER_S)
               for b, f in ((136, 28), (160, 42)))
    assert _work.agg_least_seconds(calls) == pytest.approx(want, rel=1e-12)
    assert _peaks.HBM_BYTES_PER_S == 3.35e12 and _peaks.F32_FLOP_PER_S == 67e12
