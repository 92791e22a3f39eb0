"""Port serving parity: the port's `ServingEngine` against the reference's
on the same graph, features, parameters and request trace, in union and
disjoint batching, for gcn, gin and gat.

The two engines may tune different configs (their hardware models
differ); the logits do not depend on the config, so they agree within the
normalized 1e-5 — and the batching and plan-cache lookup counts are equal."""
import jax
import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
import repro.models.gnn as j_gnn
import repro.serving as j_serving
from repro.serving.loadgen import zipf_seeds as j_zipf

from repro_torch.graphs.subgraph import extract_ego, pad_to_nodes
from repro_torch.launch import serve_gnn
from repro_torch.models import gnn as t_gnn
from repro_torch.serving import (MicroBatcher, PlanCache, Request,
                                 ServingConfig, ServingEngine, bucket_pow2,
                                 graph_key, shape_class_fingerprint,
                                 zipf_seeds)
from repro_torch.kernels import group_aggregate as t_ga


def _normalized_err(a, b):
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _engines(arch, batch_mode):
    g = j_csr.random_power_law(300, 5.0, seed=2)
    feat = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 12)).astype(np.float32)
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=12, hidden_dim=8,
                           num_classes=3, backend="xla")
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=12, hidden_dim=8,
                           num_classes=3, backend="torch", device="cpu")
    params = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(1))
    jeng = j_serving.ServingEngine(
        g, feat, jcfg, params=params,
        serving=j_serving.ServingConfig(max_batch=4, batch_mode=batch_mode,
                                        tune_iters=2, jit=False))
    teng = ServingEngine(
        g, feat, tcfg,
        params=t_gnn.params_from_jax(
            {k: np.asarray(v) for k, v in params.items()}, "cpu"),
        serving=ServingConfig(max_batch=4, batch_mode=batch_mode,
                              tune_iters=2))
    return g, jeng, teng


@pytest.mark.parametrize("arch", ["gcn", "gin", "gat"])
@pytest.mark.parametrize("batch_mode", ["union", "disjoint"])
def test_engine_matches_reference(arch, batch_mode):
    g, jeng, teng = _engines(arch, batch_mode)
    trace = j_zipf(g.num_nodes, 14, seed=3)
    np.testing.assert_array_equal(trace, zipf_seeds(g.num_nodes, 14, seed=3))
    jreqs = jeng.run_trace(trace)
    treqs = teng.run_trace(trace)
    assert [r.seed for r in jreqs] == [r.seed for r in treqs]
    for a, b in zip(treqs, jreqs):
        assert a.status == b.status == "done"
        assert _normalized_err(a.result, b.result) <= 1e-5
    js, ts = jeng.summary(), teng.summary()
    assert ts["requests"] == js["requests"]
    assert ts["batches"] == js["batches"]
    for k in ("lookups", "exact_hits", "config_hits", "misses"):
        assert ts["cache"][k] == js["cache"][k], k
    seeds = [int(s) for s in trace[:3]]
    assert _normalized_err(teng.serve_batch(seeds),
                           np.asarray(jeng.serve_batch(seeds))) <= 1e-5


def test_engine_union_equals_single_and_full_graph():
    """Ego-batched logits equal single-request and full-graph logits."""
    g = j_csr.random_power_law(250, 5.0, seed=4)
    feat = np.random.default_rng(1).standard_normal(
        (g.num_nodes, 8)).astype(np.float32)
    cfg = t_gnn.GNNConfig(arch="gcn", in_dim=8, hidden_dim=8, num_classes=3,
                          backend="torch", device="cpu")
    eng = ServingEngine(g, feat, cfg, serving=ServingConfig(tune_iters=2))
    model = t_gnn.build_gnn(g, cfg, reorder="off", tune_iters=2)
    full = model.logits(eng.params, torch.from_numpy(feat)).numpy()
    seeds = [3, 99, 200, 42]
    batched = eng.serve_batch(seeds)
    for i, s in enumerate(seeds):
        assert _normalized_err(batched[i], full[s]) <= 1e-5
        assert _normalized_err(eng.serve_batch([s])[0], full[s]) <= 1e-5


def test_engine_close_rejects_leftovers_and_refuses_submit():
    g = j_csr.random_power_law(120, 4.0, seed=5)
    feat = np.zeros((g.num_nodes, 4), np.float32)
    cfg = t_gnn.GNNConfig(arch="gcn", in_dim=4, hidden_dim=4, num_classes=2,
                          backend="torch", device="cpu")
    eng = ServingEngine(g, feat, cfg, serving=ServingConfig(max_batch=8))
    reqs = [eng.submit(s, now=0.0) for s in (1, 2, 3)]
    assert eng.close(drain=False) is False
    assert all(r.status == "rejected" for r in reqs)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(4)


def test_plan_cache_levels_and_bucketing():
    g = j_csr.random_power_law(200, 5.0, seed=6)
    cache = PlanCache(backend="torch", device="cpu", tune_iters=2)
    ego = extract_ego(g, [5], 2)
    sub = pad_to_nodes(ego.graph, bucket_pow2(ego.graph.num_nodes))
    kw = dict(arch="gin", in_dim=8, hidden_dim=8, num_layers=2)
    e1 = cache.get_or_build(sub, **kw)
    e2 = cache.get_or_build(sub, **kw)
    assert e1 is e2 and cache.stats()["exact_hits"] == 1
    T = e1.plan.partition.num_tiles
    assert T == bucket_pow2(T)                       # pow2 tile bucket
    assert e1.plan.config.variant == "folded"
    assert graph_key(sub, None, ("a",)) != graph_key(sub, None, ("b",))
    # same structure, other edge values: an exact-key miss in the same
    # shape class, so the tuned config is reused and only the plan rebuilt
    e3 = cache.get_or_build(sub, edge_vals=np.full(sub.num_edges, 0.5,
                                                   np.float32), **kw)
    assert e3 is not e1 and e3.plan.config == e1.plan.config
    assert cache.stats()["config_hits"] == 1
    assert cache.stats()["misses"] == 1
    assert shape_class_fingerprint(sub, ("x",)) != shape_class_fingerprint(
        sub, ("y",))
    assert bucket_pow2(0) == 1 and bucket_pow2(5) == 8 and bucket_pow2(8) == 8


def test_micro_batcher_fifo_and_budget():
    b = MicroBatcher(max_batch=2, max_wait=1.0)
    for i in range(3):
        b.put(Request(rid=i, seed=i, t_submit=0.0))
    assert b.ready(0.0)
    assert [r.rid for r in b.pop()] == [0, 1]
    assert not b.ready(0.5) and b.ready(1.0)
    assert [r.rid for r in b.drain()] == [2] and b.pending() == 0


def test_serve_gnn_smoke_on_cpu():
    assert serve_gnn.main(["--smoke", "--device", "cpu",
                           "--backend", "torch"]) == 0


@pytest.mark.parametrize("variant", ["slot_onehot", "direct"])
def test_serve_gnn_variant_and_plain_counts(variant):
    t_ga.reset_launches()
    res = serve_gnn.run(["--smoke", "--device", "cpu", "--backend", "torch",
                         "--arch", "gin", "--variant", variant,
                         "--requests", "8", "--verify", "1"])
    assert res["ok"]
    eng = res["engine"]
    assert eng.cache.variant == variant
    # the plain version ran (CPU) and no kernel launched
    assert t_ga.launches[t_ga.PLAIN] > 0
    assert all(t_ga.launches[k] == 0 for k in t_ga.KERNEL_OF_VARIANT.values())
