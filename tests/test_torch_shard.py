"""Port parity of the host half of graph sharding: `Plan.shards`,
`repro_torch.core.shard` (`shard_plan`, halos, edge ranges, `stats`,
`PlanShards.apply_delta` / `update_shards`) and
`Plan.apply_delta(return_details=True)`, against `repro.core.shard` and
`repro.core.plan` on the same inputs (made with numpy from a seed);
mirrors the host-side tests of `tests/test_shard.py` and
`tests/test_dynamic.py::test_shards_apply_delta_dirty_only`.

One device runs every shard: each sub-plan's executor takes the whole
feature matrix zero-padded to ``spec.padded_nodes`` rows (what the
reference's all-gather hands each device) and its rows ``[0, n_local)``
are kept; the per-shard feature gradients are summed (what the
reference's psum-scatter returns) and the edge gradients concatenated in
``edge_ranges`` order.

Tolerances, stated per test:
  * sub-graphs, partitions (forward and backward), edge permutations,
    halos, edge ranges, `stats()` and ``dirty_rows``: bit-equal (the same
    numpy code in both packages);
  * sharded vs unsharded aggregation (the reference's limits,
    `tests/test_shard.py`): forward ``max|a-b|`` <= 1e-5, summed feature
    gradients <= 1e-4, edge gradients <= 1e-3 * (1 + max|g|).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
import repro.graphs.delta as j_delta
from repro.core.advisor import plan_for as j_plan_for
from repro.core.model import AggConfig as JAggConfig
from repro.models.gnn import gcn_edge_values as j_gcn_edge_values

from repro_torch.core import shard as t_shard
from repro_torch.core.advisor import plan_for
from repro_torch.core.aggregate import PlanExecutor
from repro_torch.core.model import AggConfig
from repro_torch.graphs.csr import random_power_law
from repro_torch.graphs.delta import GraphDelta
from repro_torch.models.gnn import gcn_edge_values

PART_ARRAYS = ("nbrs", "edge_val", "local_node", "tile_node_block",
               "tile_window", "edge_slot", "edge_pos")
PART_STATICS = ("gs", "gpt", "ont", "src_win", "num_nodes", "num_edges")
CFG = dict(gs=8, gpt=8, dt=16, src_win=64, ont=8)


def _jg(g):
    return j_csr.CSRGraph(g.indptr, g.indices)


def _same_partition(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for f in PART_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for f in PART_STATICS:
        assert getattr(a, f) == getattr(b, f), f


def _same_shards(sh, jsh):
    """Every field of a port `PlanShards` bit-equal to the reference's."""
    assert dataclasses.asdict(sh.spec) == dataclasses.asdict(jsh.spec)
    assert sh.spec.padded_nodes == jsh.spec.padded_nodes
    assert sh.edge_ranges == jsh.edge_ranges
    assert sh.stats() == jsh.stats()
    assert len(sh.halo) == len(jsh.halo)
    for h, jh in zip(sh.halo, jsh.halo):
        assert h.dtype == jh.dtype
        np.testing.assert_array_equal(h, jh)
    for p, jp in zip(sh.plans, jsh.plans):
        np.testing.assert_array_equal(p.graph.indptr, jp.graph.indptr)
        np.testing.assert_array_equal(p.graph.indices, jp.graph.indices)
        _same_partition(p.partition, jp.partition)
        _same_partition(p.partition_bwd, jp.partition_bwd)
        if jp.edge_perm_bwd is None:
            assert p.edge_perm_bwd is None
        else:
            np.testing.assert_array_equal(p.edge_perm_bwd, jp.edge_perm_bwd)
        assert p.config == AggConfig(**dataclasses.asdict(jp.config))
        assert p.perm is None and p.epoch == jp.epoch


def _plans(kind, n=400, seed=3):
    """(port plan, reference plan, raw port graph) at the pinned config:
    GCN with A-hat values and a backward pair, or GAT (unit schedule
    values, dynamic per-edge values at call time)."""
    raw = random_power_law(n, 6.0, seed=seed)
    if kind == "gcn":
        g, vals = gcn_edge_values(raw)
        jg, jvals = j_gcn_edge_values(_jg(raw))
        np.testing.assert_array_equal(vals, jvals)
    else:
        g, vals = raw, None
        jg, jvals = _jg(raw), None
    plan = plan_for(g, arch=kind, in_dim=16, hidden_dim=16, edge_vals=vals,
                    config=AggConfig(**CFG), with_backward=True)
    jplan = j_plan_for(jg, arch=kind, in_dim=16, hidden_dim=16,
                       edge_vals=jvals, config=JAggConfig(**CFG),
                       with_backward=True)
    _same_partition(plan.partition, jplan.partition)
    return plan, jplan, raw


# ------------------------------------------------------------- the splitter


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_shard_plan_matches_reference(kind, num_shards):
    plan, jplan, _ = _plans(kind)
    sh, jsh = plan.shards(num_shards), jplan.shards(num_shards)
    assert isinstance(sh, t_shard.PlanShards) and sh.parent is plan
    assert sh.num_shards == num_shards
    _same_shards(sh, jsh)
    # the splitter's invariants (reference `test_shard_splitter_invariants`)
    g = plan.graph
    assert sh.edge_ranges[0][0] == 0 and sh.edge_ranges[-1][1] == g.num_edges
    for (_, b), (c, _) in zip(sh.edge_ranges[:-1], sh.edge_ranges[1:]):
        assert b == c
    tiles = {p.partition.num_tiles for p in sh.plans}
    tiles_b = {p.partition_bwd.num_tiles for p in sh.plans}
    assert len(tiles) == 1 and len(tiles_b) == 1
    for p in sh.plans:
        assert p.graph.num_nodes == sh.spec.padded_nodes
    # forward-only split of a train-ready plan
    fwd = t_shard.shard_plan(plan, num_shards, with_backward=False)
    assert all(p.partition_bwd is None for p in fwd.plans)


def _sharded(shards, feat, edge_values=None):
    """Aggregate through every shard on one device: (output in the
    parent's order, per-shard outputs over the padded feature matrix)."""
    spec = shards.spec
    pad = torch.zeros((spec.padded_nodes - feat.shape[0], feat.shape[1]))
    full = torch.cat([feat, pad])
    outs = []
    for p, (lo, hi) in zip(shards.plans, shards.edge_ranges):
        ex = PlanExecutor(p, backend="torch", device="cpu")
        y = (ex(full) if edge_values is None
             else ex.aggregate_edges(full, edge_values[lo:hi]))
        outs.append(y[:spec.n_local])
    return torch.cat(outs)[:spec.num_nodes], outs, full


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_aggregation_matches_single(num_shards):
    """Static GCN values and dynamic GAT values: the reassembled forward,
    the summed per-shard feature gradients and the concatenated edge
    gradients equal the unsharded executor's."""
    rng = np.random.default_rng(0)
    plan, _, _ = _plans("gcn")
    n = plan.graph.num_nodes
    feat = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    single = PlanExecutor(plan, backend="torch", device="cpu")
    f1 = feat.clone().requires_grad_(True)
    ref = single(f1)
    (gref,) = torch.autograd.grad((ref * cot).sum(), f1)
    shards = plan.shards(num_shards)
    out, outs, full = _sharded(shards, feat.clone().requires_grad_(True))
    assert float((out - ref).detach().abs().max()) <= 1e-5
    spec = shards.spec
    gsum = torch.zeros_like(full)
    for p, y in enumerate(outs):
        c = torch.zeros((spec.n_local, 16))
        rows = cot[p * spec.n_local:(p + 1) * spec.n_local]
        c[:rows.shape[0]] = rows
        (gp,) = torch.autograd.grad((y * c).sum(), full, retain_graph=True)
        gsum += gp
    assert float((gsum[:n] - gref).abs().max()) <= 1e-4
    assert not gsum[n:].any()

    # GAT: dynamic per-edge values sliced by edge_ranges
    gplan, _, _ = _plans("gat")
    ev = torch.from_numpy(rng.standard_normal(gplan.graph.num_edges)
                          .astype(np.float32))
    single = PlanExecutor(gplan, backend="torch", device="cpu")
    e1 = ev.clone().requires_grad_(True)
    ref = single.aggregate_edges(feat, e1)
    (eref,) = torch.autograd.grad((ref ** 2).sum(), e1)
    e2 = ev.clone().requires_grad_(True)
    out, _, _ = _sharded(gplan.shards(num_shards), feat, e2)
    assert float((out - ref).detach().abs().max()) <= 1e-5
    (esh,) = torch.autograd.grad((out ** 2).sum(), e2)
    assert float((esh - eref).abs().max()) <= 1e-3 * (
        1 + float(eref.abs().max()))


# --------------------------------------------------------- incremental split


def test_apply_delta_return_details_matches_reference():
    """``return_details=True`` returns the plan the plain call returns and
    the `DeltaResult` whose ``dirty_rows`` are the reference's."""
    plan, jplan, _ = _plans("gat")
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, 80, 40), rng.integers(0, 80, 40)
    plan2, res = plan.apply_delta(GraphDelta(add_src=src, add_dst=dst),
                                  return_details=True)
    jplan2, jres = jplan.apply_delta(
        j_delta.GraphDelta(add_src=src, add_dst=dst), return_details=True)
    np.testing.assert_array_equal(res.dirty_rows, jres.dirty_rows)
    assert len(res.dirty_rows) and res.graph is plan2.graph
    _same_partition(plan2.partition, jplan2.partition)
    _same_partition(plan2.partition_bwd, jplan2.partition_bwd)
    plain = plan.apply_delta(GraphDelta(add_src=src, add_dst=dst))
    _same_partition(plain.partition, plan2.partition)
    assert plain.stats == plan2.stats


def _ahat(g):
    inv = 1.0 / np.sqrt(np.maximum(g.degrees.astype(np.float64), 1.0))
    rows, cols = g.to_coo()
    return (inv[rows] * inv[cols]).astype(np.float32)


@pytest.mark.parametrize("kind", ["gin", "gcn"])
def test_shards_apply_delta_dirty_only(kind):
    """The reference's scenario (`tests/test_dynamic.py:221`: 600 nodes,
    40 edges inserted inside shard 0's node range): the parent patches,
    clean shards are the same `Plan` objects (GIN) or get the value-only
    refresh where GCN's degree normalization moved their values, every
    array matches the reference's update, and the split aggregates as a
    fresh ``shards(4)`` of the mutated parent."""
    raw = random_power_law(600, 7.0, seed=4)
    vals = jvals = None
    g, jg = raw, _jg(raw)
    kw = {}
    if kind == "gcn":
        g, vals = gcn_edge_values(raw)
        jg, jvals = j_gcn_edge_values(_jg(raw))
        kw = {"edge_vals": _ahat}
    plan = plan_for(g, arch=kind, in_dim=8, hidden_dim=8, edge_vals=vals,
                    config=AggConfig(**CFG), with_backward=kind == "gcn")
    jplan = j_plan_for(jg, arch=kind, in_dim=8, hidden_dim=8,
                       edge_vals=jvals, config=JAggConfig(**CFG),
                       with_backward=kind == "gcn")
    shards, jshards = plan.shards(4), jplan.shards(4)
    rng = np.random.default_rng(9)
    hi = min(shards.spec.n_local, 80)
    src, dst = rng.integers(0, hi, 40), rng.integers(0, hi, 40)
    shards2 = shards.apply_delta(GraphDelta(add_src=src, add_dst=dst), **kw)
    jshards2 = jshards.apply_delta(
        j_delta.GraphDelta(add_src=src, add_dst=dst), **kw)
    assert shards2.parent.stats["incremental"] == "patched"
    assert shards2.parent.epoch == plan.epoch + 1
    _same_shards(shards2, jshards2)
    assert shards2.plans[0] is not shards.plans[0]
    reused = [a is b for a, b in zip(shards2.plans[1:], shards.plans[1:])]
    if kind == "gin":
        assert all(reused)
    else:
        # clean shards keep their sub-graph; their values were refreshed
        # where a source's degree moved, with no repartition
        assert not all(reused)
        for a, b in zip(shards2.plans[1:], shards.plans[1:]):
            assert a.graph is b.graph
            np.testing.assert_array_equal(a.partition.nbrs, b.partition.nbrs)
    fresh = shards2.parent.shards(4)
    n = shards2.parent.graph.num_nodes
    feat = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, 8)).astype(np.float32))
    got, _, _ = _sharded(shards2, feat)
    want, _, _ = _sharded(fresh, feat)
    whole = PlanExecutor(shards2.parent, backend="torch", device="cpu")(feat)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got - whole).abs().max()) <= 1e-5


def test_update_shards_outgrows_geometry():
    """New nodes past ``spec.padded_nodes`` re-split from scratch, as the
    reference does."""
    plan, jplan, _ = _plans("gat", n=64)
    shards, jshards = plan.shards(4), jplan.shards(4)
    grow = shards.spec.padded_nodes - plan.graph.num_nodes + 3
    src = np.arange(plan.graph.num_nodes, plan.graph.num_nodes + grow)
    dst = np.zeros(grow, np.int64)
    kw = dict(add_src=src, add_dst=dst, num_new_nodes=grow)
    shards2 = shards.apply_delta(GraphDelta(**kw))
    jshards2 = jshards.apply_delta(j_delta.GraphDelta(**kw))
    assert shards2.spec.n_local > shards.spec.n_local
    _same_shards(shards2, jshards2)
