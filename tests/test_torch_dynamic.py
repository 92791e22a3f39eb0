"""Port mutable-graph parity: graph deltas, the interaction stream,
incremental plan maintenance, the serving engine's and the sampled
loader's graph swaps and ``train --sampled --stream-deltas``, against
`repro.graphs.delta`, `repro.core.incremental` / `Plan.apply_delta` and
the reference's `update_graph` paths on the same inputs (made with numpy
from a seed; weights carried with `params_from_jax`); mirrors
`tests/test_dynamic.py`.

Tolerances, stated per test:
  * deltas, the stream, patched schedules and loader batches: bit-equal
    (the same numpy code in both packages);
  * aggregation, logits and gradients on patched vs scratch vs the
    reference's patched plan: ``max|a-b| / (1 + |b|)`` <= 1e-5 (float32
    summation order differs between schedules).
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

import repro.graphs.csr as j_csr
import repro.graphs.delta as j_delta
import repro.models.gnn as j_gnn
import repro.sampling.loader as j_loader
from repro.core import incremental as j_inc
from repro.core.advisor import plan_for as j_plan_for
from repro.core.model import AggConfig as JAggConfig
from repro.core.partition import partition_graph as j_partition_graph
from repro.graphs.datasets import interaction_stream as j_stream
from repro.kernels import ops as j_ops
from repro.serving import ServingConfig as JServingConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.plan_cache import PlanCache as JPlanCache

from repro_torch.core import incremental as t_inc
from repro_torch.core.advisor import plan_for
from repro_torch.core.model import AggConfig
from repro_torch.core.partition import (pad_partition_tiles,
                                        partition_graph)
from repro_torch.core.plan import Plan
from repro_torch.graphs.csr import CSRGraph, from_edges, random_power_law
from repro_torch.graphs.datasets import interaction_stream
from repro_torch.graphs.delta import GraphDelta, apply_delta, carry_edge_values
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import train as t_train
from repro_torch.models import gnn as t_gnn
from repro_torch.sampling import loader as t_loader
from repro_torch.serving import PlanCache, ServingConfig, ServingEngine

TOL = 1e-5
PART_ARRAYS = ("nbrs", "edge_val", "local_node", "tile_node_block",
               "tile_window", "edge_slot", "edge_pos")
PART_STATICS = ("gs", "gpt", "ont", "src_win", "num_nodes", "num_edges")
CFG = dict(gs=8, gpt=8, dt=16, src_win=64, ont=8)
CPU = ["--device", "cpu", "--backend", "torch"]


def _nerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max()) if a.size else 0.0


def _jg(g):
    return j_csr.CSRGraph(g.indptr, g.indices)


def _rand_graph(rng, n=None):
    n = n or int(rng.integers(8, 64))
    e = int(rng.integers(0, 5 * n))
    return from_edges(n, rng.integers(0, n, e), rng.integers(0, n, e)), n


def _rand_delta(rng, g, n_new=None, cls=GraphDelta):
    n_new = int(rng.integers(0, 4)) if n_new is None else n_new
    n2 = g.num_nodes + n_new
    na = int(rng.integers(0, 30))
    a_src, a_dst = rng.integers(0, n2, na), rng.integers(0, n2, na)
    d_src = d_dst = None
    nd = int(rng.integers(0, 8))
    if g.num_edges and nd:
        rows = np.repeat(np.arange(g.num_nodes), g.degrees)
        eid = rng.integers(0, g.num_edges, nd)
        d_src, d_dst = g.indices[eid].astype(np.int64), rows[eid]
    dn = (rng.choice(n2, size=int(rng.integers(0, 3)), replace=False)
          if rng.random() < 0.5 else None)
    return cls(num_new_nodes=n_new, add_src=a_src, add_dst=a_dst,
               add_val=rng.random(na).astype(np.float32),
               del_src=d_src, del_dst=d_dst, del_nodes=dn)


def _to_ref_delta(d):
    return j_delta.GraphDelta(**{f.name: getattr(d, f.name)
                                 for f in dataclasses.fields(d)})


def _assert_partition_equal(tp, jp, what=""):
    for f in PART_ARRAYS:
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(
            getattr(jp, f)), err_msg=f"{what}.{f}")
    for f in PART_STATICS:
        assert getattr(tp, f) == getattr(jp, f), (what, f)


def _ahat_vals(g2):
    inv = 1.0 / np.sqrt(np.maximum(g2.degrees, 1))
    rows = np.repeat(np.arange(g2.num_nodes), g2.degrees)
    return (inv[rows] * inv[g2.indices]).astype(np.float32)


def _gcn_delta(plan, delta):
    """Mirror a raw delta onto a self-loop-carrying plan graph (the
    reference test's helper)."""
    n = plan.graph.num_nodes
    loops = np.concatenate([
        np.arange(n, n + delta.num_new_nodes, dtype=np.int64),
        np.asarray([] if delta.del_nodes is None else delta.del_nodes,
                   np.int64)])
    return dataclasses.replace(
        delta,
        add_src=np.concatenate([np.ravel(delta.add_src), loops]),
        add_dst=np.concatenate([np.ravel(delta.add_dst), loops]),
        add_val=None)


def _dense_agg(plan, x):
    """The oracle: out[v] = sum over v's CSR edges of value * x[src]."""
    g = plan.graph
    ev = plan.partition.edge_values_csr()
    ev = np.ones(g.num_edges) if ev is None else ev
    rows = np.repeat(np.arange(g.num_nodes), g.degrees)
    out = np.zeros((g.num_nodes, x.shape[1]))
    np.add.at(out, rows, ev[:, None] * x[g.indices])
    return out


# ---------------------------------------------------------------- deltas

def test_apply_delta_bit_equal_to_reference():
    """CSR arrays, dirty_rows, edge_origin, inserted_val and carried values
    equal the reference's on random graphs and deltas (new nodes, edge
    and node deletions, duplicate inserts)."""
    rng = np.random.default_rng(11)
    for _ in range(30):
        g, _ = _rand_graph(rng)
        delta = _rand_delta(rng, g)
        res = apply_delta(g, delta)
        jres = j_delta.apply_delta(_jg(g), _to_ref_delta(delta))
        np.testing.assert_array_equal(res.graph.indptr, jres.graph.indptr)
        np.testing.assert_array_equal(res.graph.indices, jres.graph.indices)
        for f in ("dirty_rows", "edge_origin", "inserted_val"):
            np.testing.assert_array_equal(getattr(res, f), getattr(jres, f))
        ev = rng.random(g.num_edges).astype(np.float32)
        np.testing.assert_array_equal(carry_edge_values(res, ev),
                                      j_delta.carry_edge_values(jres, ev))
        # CSRGraph.apply_delta is the same function
        np.testing.assert_array_equal(g.apply_delta(delta).edge_origin,
                                      res.edge_origin)


def test_delta_edge_cases():
    g = from_edges(4, [0], [1])
    res = apply_delta(g, GraphDelta(
        add_src=[2, 2, 3], add_dst=[3, 3, 2], add_val=[5.0, 9.0, 2.0]))
    assert sorted(res.inserted_val[res.edge_origin < 0].tolist()) == [2.0, 5.0]
    res = apply_delta(from_edges(5, [0, 1, 2, 3], [1, 2, 3, 4]),
                      GraphDelta(del_nodes=[2]))
    assert res.graph.num_nodes == 5 and res.graph.num_edges == 2
    res = apply_delta(g, GraphDelta(num_new_nodes=3))
    assert res.graph.num_nodes == 7 and len(res.dirty_rows) == 0
    with pytest.raises(ValueError):
        GraphDelta(add_src=[1], add_dst=[])
    with pytest.raises(ValueError):
        apply_delta(g, GraphDelta(add_src=[9], add_dst=[0]))


@pytest.mark.parametrize("feat_dim,new_node_frac,delete_frac", [
    (0, 0.05, 0.1), (8, 0.2, 0.3)])
def test_interaction_stream_bit_equal(feat_dim, new_node_frac, delete_frac):
    g = random_power_law(500, 6.0, seed=3)
    kw = dict(num_batches=4, edges_per_batch=60, feat_dim=feat_dim,
              new_node_frac=new_node_frac, delete_frac=delete_frac, seed=5)
    ours = list(interaction_stream(g, **kw))
    ref = list(j_stream(_jg(g), **kw))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


# ------------------------------------- incremental planner vs reference

@pytest.mark.parametrize("with_vals", [False, True])
def test_patch_partition_bit_equal_to_reference(with_vals):
    """`bwd_dirty_sources`, `dirty_block_fraction`, `patch_partition` and
    `patch_partition_bwd` on the same inputs give the reference's arrays."""
    from repro.core.partition import transpose_graph as j_transpose
    from repro_torch.core.partition import transpose_graph
    g = random_power_law(600, 7.0, seed=2)
    ev = (np.random.default_rng(0).random(g.num_edges).astype(np.float32)
          if with_vals else None)
    p = partition_graph(g, edge_vals=ev, **{k: CFG[k] for k in
                                            ("gs", "gpt", "ont", "src_win")})
    gT, evT, perm = transpose_graph(g, ev)
    pT = partition_graph(gT, edge_vals=evT, **{k: CFG[k] for k in
                                               ("gs", "gpt", "ont",
                                                "src_win")})
    jg = _jg(g)
    jp = j_partition_graph(jg, edge_vals=ev, **{k: CFG[k] for k in
                                                ("gs", "gpt", "ont",
                                                 "src_win")})
    jgT, jevT, jperm = j_transpose(jg, ev)
    np.testing.assert_array_equal(perm, jperm)
    jpT = j_partition_graph(jgT, edge_vals=jevT, **{k: CFG[k] for k in
                                                    ("gs", "gpt", "ont",
                                                     "src_win")})
    for seed in (4, 7):
        delta = next(interaction_stream(g, num_batches=1, edges_per_batch=30,
                                        seed=seed))
        res = apply_delta(g, delta)
        g2 = res.graph
        ev2 = None if ev is None else carry_edge_values(res, ev)
        assert (t_inc.dirty_block_fraction(res.dirty_rows, g2.num_nodes, 8)
                == j_inc.dirty_block_fraction(res.dirty_rows, g2.num_nodes,
                                              8))
        o2n, dsrc = t_inc.bwd_dirty_sources(g, g2, res.edge_origin)
        jo2n, jdsrc = j_inc.bwd_dirty_sources(jg, _jg(g2), res.edge_origin)
        np.testing.assert_array_equal(o2n, jo2n)
        np.testing.assert_array_equal(dsrc, jdsrc)
        _assert_partition_equal(
            t_inc.patch_partition(p, g2, res.dirty_rows, res.edge_origin,
                                  ev2),
            j_inc.patch_partition(jp, _jg(g2), res.dirty_rows,
                                  res.edge_origin, ev2), "fwd")
        pb, eperm = t_inc.patch_partition_bwd(pT, perm, g, g2, o2n, dsrc, ev2)
        jpb, jeperm = j_inc.patch_partition_bwd(jpT, jperm, jg, _jg(g2), jo2n,
                                                jdsrc, ev2)
        _assert_partition_equal(pb, jpb, "bwd")
        np.testing.assert_array_equal(eperm, jeperm)


def _plans(arch, with_backward, n=700, seed=0):
    """The port's and the reference's plan of one graph at one pinned
    config (GCN: the A-hat graph with self-loops)."""
    g = random_power_law(n, 8.0, seed=seed)
    gg, ev = t_gnn.gcn_edge_values(g) if arch == "gcn" else (g, None)
    kw = dict(arch=arch, in_dim=8, hidden_dim=8, num_layers=2,
              with_backward=with_backward)
    plan = plan_for(gg, edge_vals=ev, config=AggConfig(**CFG), **kw)
    jplan = j_plan_for(_jg(gg), edge_vals=ev, config=JAggConfig(**CFG), **kw)
    return g, plan, jplan


def _apply(plan, delta, arch, **kw):
    if arch == "gcn":
        return plan.apply_delta(_gcn_delta(plan, delta), edge_vals=_ahat_vals,
                                **kw)
    return plan.apply_delta(delta, **kw)


@pytest.mark.parametrize("arch,with_backward", [
    ("gin", False), ("gin", True), ("gcn", False), ("gcn", True)])
def test_plan_apply_delta_matches_reference_and_scratch(arch, with_backward):
    """Chained stream deltas through `Plan.apply_delta` (patched path):
    schedules, epochs and stats bit-equal to the reference's patched plan;
    forward and transposed aggregation equal a same-config scratch plan
    and the dense oracle within 1e-5."""
    g, plan, jplan = _plans(arch, with_backward)
    x = np.random.default_rng(5).standard_normal((plan.graph.num_nodes + 64,
                                                  8)).astype(np.float32)
    for delta in interaction_stream(g, num_batches=3, edges_per_batch=50,
                                    seed=1):
        plan2 = _apply(plan, delta, arch, threshold=1.0)
        jplan2 = _apply(jplan, _to_ref_delta(delta), arch, threshold=1.0)
        assert plan2.stats == jplan2.stats
        assert plan2.stats["incremental"] == "patched"
        assert plan2.epoch == jplan2.epoch == plan.epoch + 1
        _assert_partition_equal(plan2.partition, jplan2.partition, "fwd")
        if with_backward:
            _assert_partition_equal(plan2.partition_bwd,
                                    jplan2.partition_bwd, "bwd")
            np.testing.assert_array_equal(plan2.edge_perm_bwd,
                                          jplan2.edge_perm_bwd)
        scratch = plan_for(plan2.graph, arch=arch, in_dim=8, hidden_dim=8,
                           num_layers=2, config=plan.config,
                           edge_vals=(_ahat_vals(plan2.graph)
                                      if arch == "gcn" else None),
                           with_backward=with_backward)
        xs = torch.from_numpy(x[:plan2.graph.num_nodes])
        outs = [t_ops.aggregate(xs, p.sched(), backend="torch").numpy()
                for p in (plan2, scratch)]
        assert _nerr(outs[0], outs[1]) <= TOL
        assert _nerr(outs[0], _dense_agg(plan2, xs.numpy())) <= TOL
        if with_backward:
            outsT = [t_ops.aggregate(xs, p.sched_bwd(), backend="torch")
                     .numpy() for p in (plan2, scratch)]
            assert _nerr(outsT[0], outsT[1]) <= TOL
        plan, jplan = plan2, jplan2


def test_fallback_above_threshold_matches_reference():
    rng = np.random.default_rng(7)
    g = random_power_law(400, 6.0, seed=2)
    kw = dict(arch="gin", in_dim=8, hidden_dim=8, num_layers=2,
              with_backward=True)
    plan = plan_for(g, config=AggConfig(**CFG), **kw)
    jplan = j_plan_for(_jg(g), config=JAggConfig(**CFG), **kw)
    big = GraphDelta(add_src=rng.integers(0, 400, 1200),
                     add_dst=rng.integers(0, 400, 1200))
    plan2 = plan.apply_delta(big)
    jplan2 = jplan.apply_delta(_to_ref_delta(big))
    assert plan2.stats == jplan2.stats
    assert plan2.stats["incremental"] == "fallback"
    _assert_partition_equal(plan2.partition, jplan2.partition, "fwd")
    _assert_partition_equal(plan2.partition_bwd, jplan2.partition_bwd, "bwd")


@pytest.mark.parametrize("arch", ["gcn", "gin"])
def test_patched_logits_and_gradients_match(arch):
    """Patched vs scratch vs the reference's patched plan, through the
    model's logits and the autograd `Function`'s feature gradient (the
    transposed patched schedule) on carried weights."""
    g, plan, jplan = _plans(arch, True, n=500, seed=3)
    delta = next(interaction_stream(g, num_batches=1, edges_per_batch=40,
                                    seed=2))
    plan2 = _apply(plan, delta, arch, threshold=1.0)
    jplan2 = _apply(jplan, _to_ref_delta(delta), arch, threshold=1.0)
    assert plan2.stats["incremental"] == "patched"
    scratch = plan_for(plan2.graph, arch=arch, in_dim=8, hidden_dim=8,
                       num_layers=2, config=plan.config, with_backward=True,
                       edge_vals=(_ahat_vals(plan2.graph)
                                  if arch == "gcn" else None))
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=8, hidden_dim=8, num_classes=3,
                           backend="xla")
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=8, hidden_dim=8, num_classes=3,
                           backend="torch", device="cpu")
    jparams = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(2))
    tparams = t_gnn.params_from_jax({k: np.asarray(v)
                                     for k, v in jparams.items()}, "cpu")
    n2 = plan2.graph.num_nodes
    x = np.random.default_rng(8).standard_normal((n2, 8)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((n2, 8)).astype(np.float32)

    def t_logits(p):
        m = t_gnn.GNNModel(cfg=tcfg, plan=p,
                           executor=p.executor("torch", "cpu"),
                           params=tparams)
        return m.logits(tparams, torch.from_numpy(x)).detach().numpy()

    jm = j_gnn.GNNModel(cfg=jcfg, plan=jplan2,
                        executor=jplan2.executor("xla"), params=jparams)
    ref = np.asarray(jm.logits(jparams, jnp.asarray(x)))
    assert _nerr(t_logits(plan2), ref) <= TOL
    assert _nerr(t_logits(plan2), t_logits(scratch)) <= TOL

    def t_grad(p):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = t_ops.aggregate(xt, p.sched(), backend="torch",
                              sched_bwd=p.sched_bwd())
        (out * torch.from_numpy(w)).sum().backward()
        return xt.grad.numpy()

    jgrad = np.asarray(jax.grad(lambda f: (j_ops.aggregate(
        f, jplan2.sched(), backend="xla", sched_bwd=jplan2.sched_bwd())
        * w).sum())(jnp.asarray(x)))
    assert _nerr(t_grad(plan2), jgrad) <= TOL
    assert _nerr(t_grad(plan2), t_grad(scratch)) <= TOL


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), n_new=st.integers(0, 24),
       padded=st.booleans(), gcn=st.booleans())
def test_prop_patched_schedules_meet_kernel_contract(seed, n_new, padded,
                                                     gcn):
    """Every patched schedule (new nodes appended past the old end, a
    pow2-padded start plan, forward and transposed) builds a
    `DeviceSchedule` — one run per node block (`run_bounds`), ids inside
    their windows, edge-free tiles only inside a run or past the live
    prefix — and aggregates like the dense oracle."""
    rng = np.random.default_rng(seed)
    g = random_power_law(int(rng.integers(80, 400)), 5.0, seed=seed)
    arch = "gcn" if gcn else "gin"
    gg, ev = t_gnn.gcn_edge_values(g) if gcn else (g, None)
    plan = plan_for(gg, arch=arch, in_dim=8, hidden_dim=8, num_layers=2,
                    edge_vals=ev, config=AggConfig(**CFG), with_backward=True)
    if padded:
        plan = dataclasses.replace(
            plan,
            partition=pad_partition_tiles(
                plan.partition, 2 * plan.partition.num_tiles + 1),
            partition_bwd=pad_partition_tiles(
                plan.partition_bwd, 2 * plan.partition_bwd.num_tiles + 1))
    for _ in range(3):
        delta = _rand_delta(rng, plan.graph if not gcn else g, n_new=n_new)
        if gcn:
            plan = plan.apply_delta(_gcn_delta(plan, delta),
                                    edge_vals=_ahat_vals, threshold=1.0)
            g = apply_delta(g, delta).graph
        else:
            plan = plan.apply_delta(delta, threshold=1.0)
        assert plan.stats["incremental"] == "patched"
        x = rng.standard_normal((plan.graph.num_nodes, 4)).astype(np.float32)
        for part, perm in ((plan.partition, None),
                           (plan.partition_bwd, plan.edge_perm_bwd)):
            sched = t_ops.DeviceSchedule(part, "cpu", edge_perm=perm)
            bounds = t_ops.run_bounds(part.tile_node_block[:sched.live_tiles])
            assert len(bounds) - 1 == sched.num_runs
            assert not part.edge_val[sched.live_tiles:].any()
        out = t_ops.aggregate(torch.from_numpy(x), plan.sched(),
                              backend="torch").numpy()
        assert _nerr(out, _dense_agg(plan, x)) <= TOL


# ---------------------------------------------------- serving adoption

def test_serving_engine_update_graph_matches_reference_and_fresh():
    """After `update_graph` the port engine serves the reference engine's
    logits (same delta, carried weights) and a fresh port engine's on the
    mutated graph; the epoch is bumped and pre-mutation plans dropped."""
    rng = np.random.default_rng(2)
    g = random_power_law(500, 6.0, seed=1)
    feat = rng.standard_normal((g.num_nodes, 8)).astype(np.float32)
    jcfg = j_gnn.GNNConfig(arch="gcn", in_dim=8, hidden_dim=8, num_classes=3,
                           backend="xla")
    tcfg = t_gnn.GNNConfig(arch="gcn", in_dim=8, hidden_dim=8, num_classes=3,
                           backend="torch", device="cpu")
    jparams = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(4))
    tparams = t_gnn.params_from_jax({k: np.asarray(v)
                                     for k, v in jparams.items()}, "cpu")
    e1 = ServingEngine(g, feat, tcfg, params=tparams,
                       serving=ServingConfig(max_batch=32, tune_iters=2))
    j1 = JServingEngine(_jg(g), feat, jcfg, params=jparams,
                        serving=JServingConfig(max_batch=32, tune_iters=2,
                                               jit=False))
    e1.serve_batch([1, 2, 3])
    assert e1.cache.num_plans >= 1
    delta = next(interaction_stream(g, num_batches=1, edges_per_batch=40,
                                    feat_dim=8, seed=3))
    res = e1.update_graph(delta)
    j1.update_graph(_to_ref_delta(delta))
    assert e1.graph_epoch == j1.graph_epoch == 1
    assert e1.cache.num_plans == 0
    assert e1.cache.stats()["invalidations"] >= 1
    np.testing.assert_array_equal(e1.feat, j1.feat)
    np.testing.assert_array_equal(e1.src_vals, j1.src_vals)
    feat2 = np.concatenate([feat, delta.node_feat])
    e2 = ServingEngine(res.graph, feat2, tcfg, params=tparams,
                       serving=ServingConfig(max_batch=32, tune_iters=2))
    nodes = [int(v) for v in rng.choice(res.graph.num_nodes, 24,
                                        replace=False)] + [g.num_nodes]
    out1 = e1.serve_batch(nodes)
    assert _nerr(out1, np.asarray(j1.serve_batch(nodes))) <= TOL
    assert _nerr(out1, e2.serve_batch(nodes)) <= TOL


def test_plan_cache_epoch_keys_and_invalidation():
    g = random_power_law(300, 5.0, seed=0)
    cache = PlanCache(backend="torch", device="cpu", tune_iters=2)
    jcache = JPlanCache(tune_iters=2)
    kw = dict(arch="gin", in_dim=8, hidden_dim=8, num_layers=2)
    e0 = cache.get_or_build(g, epoch=0, **kw)
    assert cache.get_or_build(g, epoch=0, **kw).plan is e0.plan
    e1 = cache.get_or_build(g, epoch=1, **kw)
    assert e1.plan is not e0.plan and (e0.epoch, e1.epoch) == (0, 1)
    assert cache.get_or_build(g, **kw).epoch == 0      # no epoch: key as before
    assert cache.invalidate(before_epoch=1) == 2
    assert cache.num_configs == 1                       # the memo survives
    assert cache.get_or_build(g, epoch=1, **kw).plan is e1.plan
    for epoch in (0, 1):
        jcache.get_or_build(_jg(g), epoch=epoch, **kw)
    assert jcache.invalidate(before_epoch=1) == 1
    assert cache.invalidate(fingerprint=e1.fingerprint) == 2   # plan + memo
    cache.get_or_build(g, epoch=2, **kw)
    assert cache.invalidate() == 2
    st_ = cache.stats()
    assert st_["invalidations"] == 6 and st_["plans"] == st_["configs"] == 0
    assert cache.registry.counter(
        "plan_cache_invalidations_total").value == 6


def test_plan_npz_roundtrip_keeps_epoch(tmp_path):
    g = random_power_law(300, 5.0, seed=6)
    plan = plan_for(g, arch="gin", in_dim=8, hidden_dim=8, num_layers=2,
                    config=AggConfig(**CFG), with_backward=True)
    plan = plan.apply_delta(GraphDelta(add_src=[1, 2], add_dst=[3, 4]))
    path = str(tmp_path / "plan.npz")
    plan.save(path)
    back = Plan.load(path)
    assert back.epoch == plan.epoch == 1
    _assert_partition_equal(back.partition, plan.partition)
    np.testing.assert_array_equal(back.edge_perm_bwd, plan.edge_perm_bwd)


# ------------------------------------------------------ sampled loader

def _loader_pair(arch="gcn"):
    jg = j_csr.random_power_law(400, 8.0, seed=0)
    tg = CSRGraph(jg.indptr, jg.indices)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((tg.num_nodes, 8)).astype(np.float32)
    labels = t_gnn.structural_labels(tg, 3)
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=8, hidden_dim=8, num_classes=3,
                           backend="xla")
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=8, hidden_dim=8, num_classes=3,
                           backend="torch", device="cpu")
    jl = j_loader.SampledLoader(
        jg, feat, labels, jcfg,
        j_loader.LoaderConfig(fanouts=(4, 2), batch_nodes=64, seed=0),
        start_thread=False, with_backward=True)
    tl = t_loader.SampledLoader(
        tg, feat, labels, tcfg,
        t_loader.LoaderConfig(fanouts=(4, 2), batch_nodes=64, seed=0),
        start_thread=False, with_backward=True)
    return tg, feat, labels, tcfg, jl, tl


def _assert_batch_equal(tb, jb):
    np.testing.assert_array_equal(tb.seeds, jb.seeds)
    assert tb.raw_nodes == jb.raw_nodes and tb.raw_edges == jb.raw_edges
    for te, je in zip(tb.entries, jb.entries):
        _assert_partition_equal(te.plan.partition, je.plan.partition, "fwd")
        _assert_partition_equal(te.plan.partition_bwd, je.plan.partition_bwd,
                                "bwd")
    np.testing.assert_array_equal(tb.feat.numpy(), np.asarray(jb.feat))
    np.testing.assert_array_equal(tb.labels.numpy(), jb.labels)
    np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)


def test_loader_blocks_after_swap_bit_equal_to_reference():
    tg, feat, labels, _, jl, tl = _loader_pair()
    deltas = list(interaction_stream(tg, num_batches=2, edges_per_batch=60,
                                     feat_dim=8, seed=2))
    for k, delta in enumerate(deltas, start=1):
        tl.update_graph(delta)
        jl.update_graph(_to_ref_delta(delta))
        for step in (0, 3, 5):
            tb, jb = tl(step), jl(step)
            assert tb.graph_epoch == k
            _assert_batch_equal(tb, jb)
        assert tl.steps_per_epoch == jl.steps_per_epoch
        assert tl.g.num_nodes == jl.g.num_nodes
        np.testing.assert_array_equal(tl.feat, jl.feat)
        np.testing.assert_array_equal(tl.labels, jl.labels)
    st_ = tl.stats()
    assert st_["graph_epoch"] == st_["graph_swaps"] == 2


def test_prefetching_loader_never_hands_out_old_graph_batches():
    """With the worker thread: after `update_graph` returns, every batch
    the loader hands out is built from the new snapshot and equals the
    no-thread loader's batch for the step, also while a batch was in
    flight or buffered at the swap."""
    tg, feat, labels, tcfg, _, plain = _loader_pair()
    lc = t_loader.LoaderConfig(fanouts=(4, 2), batch_nodes=64, seed=0)
    deltas = list(interaction_stream(tg, num_batches=3, edges_per_batch=60,
                                     feat_dim=8, seed=2))
    with t_loader.SampledLoader(tg, feat, labels, tcfg, lc,
                                with_backward=True) as tl:
        step = 0
        for k, delta in enumerate(deltas, start=1):
            for _ in range(2):
                assert tl(step).graph_epoch == k - 1
                step += 1
            tl.update_graph(delta)
            plain.update_graph(delta)
            for _ in range(2):
                b = tl(step)
                assert b.graph_epoch == k
                _assert_batch_equal(b, plain.batch_for(step))
                step += 1
        assert tl.stats()["graph_swaps"] == 3


def test_loader_updates_given_while_a_batch_is_in_flight_compose():
    """Two deltas given while the worker is mid-batch compose: the second
    applies to the first's pending snapshot (its new-node ids count from
    there), both land in ``loader.g`` and each is one graph epoch."""
    tg, feat, labels, tcfg, _, plain = _loader_pair()
    lc = t_loader.LoaderConfig(fanouts=(4, 2), batch_nodes=64, seed=0)
    d1, d2 = interaction_stream(tg, num_batches=2, edges_per_batch=60,
                                feat_dim=8, seed=2)
    assert d1.num_new_nodes and d2.num_new_nodes
    entered, gate = threading.Event(), threading.Event()

    class Gated(t_loader.SampledLoader):
        def batch_for(self, step):
            if step == 2 and not gate.is_set():
                entered.set()                      # step 2 is in flight
                assert gate.wait(30.0)
            return super().batch_for(step)

    with Gated(tg, feat, labels, tcfg, lc, with_backward=True) as tl:
        assert tl(0).graph_epoch == 0
        assert entered.wait(30.0)
        tl.update_graph(d1)
        tl.update_graph(d2)
        assert tl.graph_epoch == 0                 # waits for step 2
        gate.set()
        b = tl(1)
        plain.update_graph(d1)
        plain.update_graph(d2)
        assert b.graph_epoch == 2
        _assert_batch_equal(b, plain.batch_for(1))
        assert tl.g.num_nodes == (tg.num_nodes + d1.num_new_nodes
                                  + d2.num_new_nodes)
        np.testing.assert_array_equal(tl.g.indptr, plain.g.indptr)
        np.testing.assert_array_equal(tl.g.indices, plain.g.indices)
        np.testing.assert_array_equal(tl.feat, plain.feat)
        st_ = tl.stats()
        assert st_["graph_epoch"] == st_["graph_swaps"] == 2


def test_driver_sampled_stream_deltas_cpu(tmp_path):
    res = t_train.run(["--arch", "gcn", "--sampled", "--dataset", "cora",
                       "--steps", "7", "--stream-deltas", "3",
                       "--batch-nodes", "128", "--ckpt-dir", str(tmp_path)]
                      + CPU)
    assert res["ok"] and len(res["history"]) == 7
    assert res["stream"].applied == 2 and res["stream"].applied_at == [3, 6]
    assert res["stats"]["graph_epoch"] == res["stats"]["graph_swaps"] == 2
    assert res["loader"].g.num_nodes > 2708          # new nodes appended


def test_driver_stream_deltas_needs_cuda_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.run(["--arch", "gcn", "--sampled", "--dataset", "cora",
                     "--steps", "2", "--stream-deltas", "1",
                     "--ckpt-dir", str(tmp_path)])
