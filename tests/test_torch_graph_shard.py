"""Port parity of multi-rank graph execution: `repro_torch.distributed`
(`ranks`: the rank group; `graph_shard`: `ShardedExecutor`,
`make_sharded_logits_fn`, `make_sharded_train_step`),
`models.gnn.gnn_sharded_logits`, `optim.compressed_psum` and
`obs.profile_plan(shards=)`, against the reference on the same inputs
(made with numpy from a seed).

Every sharded call runs on a group of gloo ranks on the CPU (spawned
processes; `shard_group` keeps one group per shard count for the
module).  The references are the reference's SINGLE-device results
(`PlanExecutor(backend="xla")`, `GNNModel.logits`,
`make_gnn_train_step`); its own sharded path is not the reference,
since its sharded-model test holds GIN logits of magnitude ~170 to an
absolute 1e-5.  ``compressed_psum`` runs in the reference under
``jax.vmap(..., axis_name="shard")``.

Tolerances, stated per test, all in ``max|a-b| / (1 + max|b|)``:
forward 1e-5, feature gradient 1e-4, edge-value gradient 1e-3 (the
reference's limits, `tests/test_shard.py`), logits 1e-5, train-step
loss and parameters 1e-4; compressed sums and residuals bit-equal.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _shard_ranks
import repro.graphs.csr as j_csr
import repro.obs.profile as j_profile
import repro.optim.compression as j_comp
from repro.core.advisor import plan_for as j_plan_for
from repro.core.aggregate import PlanExecutor as JPlanExecutor
from repro.core.model import AggConfig as JAggConfig
from repro.models.gnn import GNNConfig as JGNNConfig
from repro.models.gnn import build_gnn as j_build_gnn
from repro.models.gnn import make_gnn_train_step as j_make_gnn_train_step
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init

import repro_torch.obs.profile as t_profile
from repro_torch.core.advisor import advise, plan_for
from repro_torch.core.model import AggConfig
from repro_torch.distributed import (RankError, RankGroup, ShardedExecutor,
                                     check_dist_backend,
                                     make_sharded_logits_fn,
                                     make_sharded_train_step, shard_group)
from repro_torch.graphs.csr import random_power_law
from repro_torch.models.gnn import (GNNConfig, gcn_edge_values,
                                    params_from_jax)
from repro_torch.optim.adamw import AdamWConfig, adamw_init

CFG = dict(gs=8, gpt=8, dt=16, src_win=64, ont=8)
LIMITS = {"forward": 1e-5, "feat_grad": 1e-4, "edge_grad": 1e-3}


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _jg(g):
    return j_csr.CSRGraph(g.indptr, g.indices)


def _group(p):
    return shard_group(p, device="cpu", timeout=120)


# ------------------------------------------------------ ShardedExecutor

@functools.lru_cache(maxsize=1)
def _executor_case():
    """Plans (GCN A-hat and GAT, train-ready) of one graph in both
    packages, seeded features and edge values, and the reference's
    single-device outputs and gradients of ``sum(out**2)``."""
    g, vals = gcn_edge_values(random_power_law(501, 6.0, seed=3))
    plan = plan_for(g, arch="gcn", in_dim=16, edge_vals=vals,
                    config=AggConfig(**CFG), with_backward=True)
    jplan = j_plan_for(_jg(g), arch="gcn", in_dim=16, edge_vals=vals,
                       config=JAggConfig(**CFG), with_backward=True)
    planD = plan_for(g, arch="gat", in_dim=16, config=AggConfig(**CFG),
                     with_backward=True)
    jplanD = j_plan_for(_jg(g), arch="gat", in_dim=16,
                        config=JAggConfig(**CFG), with_backward=True)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
    ev = rng.standard_normal(g.num_edges).astype(np.float32)

    jex = JPlanExecutor(jplan, backend="xla")
    ref = np.asarray(jex(jnp.asarray(feat)))
    gref = np.asarray(jax.grad(lambda f: (jex(f) ** 2).sum())(
        jnp.asarray(feat)))
    jexD = JPlanExecutor(jplanD, backend="xla")
    refD = np.asarray(jexD.aggregate_edges(jnp.asarray(feat),
                                           jnp.asarray(ev)))
    grefD_f, grefD_e = (np.asarray(t) for t in jax.grad(
        lambda f, e: (jexD.aggregate_edges(f, e) ** 2).sum(),
        argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(ev)))
    return (g, plan, planD, feat, ev, ref, gref, refD, grefD_f, grefD_e)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_executor_matches_single_device_reference(num_shards):
    """Static GCN A-hat values and dynamic (GAT) edge values through
    `ShardedExecutor` on P ranks: the output, the feature gradient and
    the edge-value gradient of ``sum(out**2)`` against the reference's
    single-device ``xla`` executor on the same plan."""
    (g, plan, planD, feat, ev, ref, gref, refD, grefD_f,
     grefD_e) = _executor_case()
    grp = _group(num_shards)
    ex = ShardedExecutor(plan.shards(num_shards), backend="torch",
                         device="cpu", group=grp)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = ex(f)
    (gx,) = torch.autograd.grad((out ** 2).sum(), [f])
    assert out.shape == (g.num_nodes, 16) and gx.shape == f.shape
    assert _nerr(out.detach(), ref) <= LIMITS["forward"]
    assert _nerr(gx, gref) <= LIMITS["feat_grad"]

    exD = ShardedExecutor(planD.shards(num_shards), backend="torch",
                          device="cpu", group=grp)
    f = torch.from_numpy(feat).requires_grad_(True)
    e = torch.from_numpy(ev).requires_grad_(True)
    outD = exD.aggregate_edges(f, e)
    gf, ge = torch.autograd.grad((outD ** 2).sum(), [f, e])
    assert _nerr(outD.detach(), refD) <= LIMITS["forward"]
    assert _nerr(gf, grefD_f) <= LIMITS["feat_grad"]
    assert _nerr(ge, grefD_e) <= LIMITS["edge_grad"]
    # without a gradient asked for, the forward alone
    with torch.no_grad():
        assert _nerr(exD.aggregate_edges(torch.from_numpy(feat),
                                         torch.from_numpy(ev)), refD) <= 1e-5
    # the partition gauges of the reference's executor
    names = {m["name"] for m in ex.registry.snapshot()}
    assert {"shard_edge_balance", "shard_halo_nodes",
            "shard_halo_bytes"} <= names
    ex.close()
    exD.close()


@pytest.mark.parametrize("case", ["chain", "gat_two_layers",
                                  "earlier_output_only"])
def test_sharded_executor_calls_compose(case):
    """Several differentiable calls on one `ShardedExecutor` before one
    backward: ``ex(ex(x))``, two GAT layers through ``aggregate_edges``
    with their own edge values, and two calls of which only the first
    reaches the loss.  Gradients against the reference's single-device
    ``xla`` executor composed under ``jax.grad`` (limits of the test
    above); afterwards no call's saved tensors stay on the ranks."""
    g, plan, planD, feat, ev, *_ = _executor_case()
    grp = _group(2)
    ev2 = np.random.default_rng(1).standard_normal(
        g.num_edges).astype(np.float32)
    f = torch.from_numpy(feat).requires_grad_(True)
    if case == "gat_two_layers":
        jex = JPlanExecutor(_jplan("gat"), backend="xla")
        ex = ShardedExecutor(planD.shards(2), backend="torch", device="cpu",
                             group=grp)
        e1, e2 = (torch.from_numpy(v).requires_grad_(True)
                  for v in (ev, ev2))
        out = ex.aggregate_edges(ex.aggregate_edges(f, e1), e2)
        got = torch.autograd.grad((out ** 2).sum(), [f, e1, e2])
        want = jax.grad(lambda x, a, b: (jex.aggregate_edges(
            jex.aggregate_edges(x, a), b) ** 2).sum(), argnums=(0, 1, 2))(
            jnp.asarray(feat), jnp.asarray(ev), jnp.asarray(ev2))
        ref_out = jex.aggregate_edges(jex.aggregate_edges(
            jnp.asarray(feat), jnp.asarray(ev)), jnp.asarray(ev2))
        lims = [LIMITS["feat_grad"], LIMITS["edge_grad"],
                LIMITS["edge_grad"]]
    else:
        jex = JPlanExecutor(_jplan("gcn"), backend="xla")
        ex = ShardedExecutor(plan.shards(2), backend="torch", device="cpu",
                             group=grp)
        if case == "chain":
            out = ex(ex(f))
            ref_out = jex(jex(jnp.asarray(feat)))
            want = jax.grad(lambda x: (jex(jex(x)) ** 2).sum())(
                jnp.asarray(feat))
        else:
            out = ex(f)
            unused = ex(f * 3.0)
            ref_out = jex(jnp.asarray(feat))
            want = jax.grad(lambda x: (jex(x) ** 2).sum())(jnp.asarray(feat))
        got = torch.autograd.grad((out ** 2).sum(), [f])
        want, lims = [want], [LIMITS["feat_grad"]]
        if case == "earlier_output_only":
            assert _shard_ranks_saved(grp, ex) == [1, 1]
            del unused
    assert _nerr(out.detach(), ref_out) <= LIMITS["forward"]
    for a, b, lim in zip(got, want, lims):
        assert _nerr(a, b) <= lim
    del out
    x0 = torch.from_numpy(feat)
    with torch.no_grad():                 # drops the slots of dead nodes
        if case == "gat_two_layers":
            ex.aggregate_edges(x0, torch.from_numpy(ev))
        else:
            ex(x0)
    assert _shard_ranks_saved(grp, ex) == [0, 0]
    ex.close()


@functools.lru_cache(maxsize=2)
def _jplan(arch):
    """The reference's plan of `_executor_case`'s graph for ``arch``."""
    g, vals = gcn_edge_values(random_power_law(501, 6.0, seed=3))
    return j_plan_for(_jg(g), arch=arch, in_dim=16,
                      edge_vals=vals if arch == "gcn" else None,
                      config=JAggConfig(**CFG), with_backward=True)


def _shard_ranks_saved(grp, ex) -> list:
    return grp.run(_shard_ranks.r_saved_calls, None, ex.key)


# ---------------------------------------------------- the sharded model

@functools.lru_cache(maxsize=2)
def _models(arch):
    """The reference's and the port's GNN on one renumbered graph (the
    reference's weights are carried across with `params_from_jax`), and
    the reference's single-device logits and train step (AdamW at lr
    1e-2) on a seeded masked batch."""
    g = random_power_law(600, 6.0, seed=1)
    jcfg = JGNNConfig(arch=arch, in_dim=12, hidden_dim=16, num_classes=5,
                      num_layers=2, backend="xla")
    jm = j_build_gnn(_jg(g), jcfg, reorder="on", tune_iters=2, seed=0,
                     with_backward=True)
    cfg = GNNConfig(arch=arch, in_dim=12, hidden_dim=16, num_classes=5,
                    num_layers=2, backend="torch", device="cpu")
    src = gcn_edge_values(g) if arch == "gcn" else (g, None)
    plan = advise(src[0], arch=arch, in_dim=12, hidden_dim=16,
                  num_layers=2, edge_vals=src[1], reorder="on",
                  tune_iters=2, seed=0, with_backward=True)
    if arch == "gin":
        np.testing.assert_array_equal(plan.perm, jm.plan.perm)
    rng = np.random.default_rng(0)
    feat0 = rng.standard_normal((g.num_nodes, 12)).astype(np.float32)
    labels0 = rng.integers(0, 5, g.num_nodes).astype(np.int32)
    feat = plan.renumber_features(feat0)
    labels = plan.renumber_features(labels0)
    mask = (rng.random(g.num_nodes) < 0.7).astype(np.float32)
    jfeat = jnp.asarray(feat)
    ref_lg = np.asarray(jm.logits(jm.params, jfeat))
    jstate = (jm.params, j_adamw_init(jm.params))
    jbatch = {"feat": jfeat, "labels": jnp.asarray(labels),
              "mask": jnp.asarray(mask)}
    (jp1, _), jmet = j_make_gnn_train_step(jm, JAdamWConfig(lr=1e-2))(
        jstate, jbatch)
    return (jm, cfg, plan, feat, labels, mask, ref_lg,
            {k: np.asarray(v) for k, v in jp1.items()}, float(jmet["loss"]))


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("arch", ["gcn", "gin"])
def test_sharded_model_matches_single_device_reference(arch, num_shards):
    """GCN and GIN on a renumbered graph: sharded logits against the
    reference's single-device `GNNModel.logits` (1e-5), and one sharded
    train step (masked loss, AdamW) against `make_gnn_train_step`: loss
    and new parameters within 1e-4 (the reference's sharded-model test
    on the scaled metric)."""
    jm, cfg, plan, feat, labels, mask, ref_lg, jp1, jloss = _models(arch)
    params = params_from_jax(jm.params, "cpu")
    shards = plan.shards(num_shards)
    grp = _group(num_shards)
    logits_fn = make_sharded_logits_fn(cfg, shards, group=grp)
    lg = logits_fn(params, torch.from_numpy(feat))
    assert lg.shape == ref_lg.shape and lg.dtype == torch.float32
    assert _nerr(lg, ref_lg) <= 1e-5
    step = make_sharded_train_step(cfg, shards, AdamWConfig(lr=1e-2),
                                   group=grp)
    batch = {"feat": torch.from_numpy(feat),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask)}
    (p1, _), met = step((params, adamw_init(params)), batch)
    assert abs(float(met["loss"]) - jloss) <= 1e-4 * (1 + abs(jloss))
    for k in p1:
        assert _nerr(p1[k], jp1[k]) <= 1e-4, k
    logits_fn.model.close()
    step.close()


def test_sharded_model_sends_inputs_once():
    """A second step on the same batch sends no rows again; a new feature
    tensor goes to the ranks once."""
    jm, cfg, plan, feat, labels, *_ = _models("gcn")
    grp = _group(2)
    step = make_sharded_train_step(cfg, plan.shards(2),
                                   AdamWConfig(lr=1e-2), group=grp)
    params = params_from_jax(jm.params, "cpu")
    batch = {"feat": torch.from_numpy(feat),
             "labels": torch.from_numpy(labels).long()}
    calls = []
    run = grp.run

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return run(fn, *a, **kw)

    grp.run = counting
    try:
        state = (params, adamw_init(params))
        state, m0 = step(state, batch)
        state, m1 = step(state, batch)
    finally:
        del grp.run
    assert calls.count("_r_set") == 3          # feat, labels, mask once
    assert calls.count("_r_value_and_grad") == 2
    assert float(m1["loss"]) < float(m0["loss"])
    step.close()


def test_sharded_model_refuses_gat():
    jm, cfg, plan, *_ = _models("gcn")
    import dataclasses
    with pytest.raises(NotImplementedError, match="gcn/gin"):
        make_sharded_logits_fn(dataclasses.replace(cfg, arch="gat"),
                               plan.shards(2), group=_group(2))


# ---------------------------------------------------- re-sharding

@pytest.mark.parametrize("arch,resent", [("gin", [0]), ("gcn", [0, 1, 2])])
def test_sharded_serve_update_sends_only_changed_subplans(arch, resent):
    """`make_sharded_serve_fn.update_graph` with a delta inside shard 0's
    node range: shard 0 is sent again; GIN's clean shards are the same
    `Plan` objects and are not sent; GCN's clean shards whose A-hat
    values moved with shard 0's degrees are new objects and are sent.
    Afterwards the served logits equal a fresh split's of the mutated
    plan (1e-5)."""
    from repro_torch.graphs.delta import GraphDelta
    from repro_torch.launch.serve_gnn import _fresh_split_err
    from repro_torch.serving import make_sharded_serve_fn

    g = random_power_law(600, 4.0, seed=2)
    feat = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 8)).astype(np.float32)
    cfg = GNNConfig(arch=arch, in_dim=8, hidden_dim=8, num_classes=3,
                    backend="torch", device="cpu")
    fn = make_sharded_serve_fn(g, feat, cfg, num_shards=3, tune_iters=2)
    try:
        n_local = fn.shards.spec.n_local
        rng = np.random.default_rng(1)
        dst, src = g.to_coo()
        inside = np.flatnonzero((dst < 20) & (src < 20) & (dst != src))
        delta = GraphDelta(add_src=rng.integers(0, 20, 16),
                           add_dst=rng.integers(0, 20, 16),
                           del_src=src[inside[:4]], del_dst=dst[inside[:4]])
        fn.update_graph(delta)
        assert fn.resent == [resent]
        assert n_local == fn.shards.spec.n_local
        assert _fresh_split_err(fn, cfg, 3) <= 1e-5
    finally:
        fn.close()


# ---------------------------------------------------- compressed_psum

def test_compressed_psum_bit_equal_to_reference():
    """Ten error-feedback steps of `compressed_psum` on four gloo ranks:
    every step's totals (replicated) and every rank's residuals
    bit-equal to the reference's under ``jax.vmap(axis_name="shard")``."""
    P, steps = 4, 10
    got = _group(P).run(_shard_ranks.r_compressed_psum, None, steps)

    def body(g, e):
        return j_comp.compressed_psum(g, e, "shard")

    vbody = jax.vmap(body, axis_name="shard")
    je = None
    for step in range(steps):
        grads = [_shard_ranks.psum_grads(p, step) for p in range(P)]
        jg = {k: jnp.stack([g[k] for g in grads]) for k in grads[0]}
        if je is None:
            je = {k: jnp.zeros_like(v) for k, v in jg.items()}
        jtot, je = vbody(jg, je)
        for p in range(P):
            tot, res = got[p][step]
            for k in jg:
                assert tot[k].tobytes() == np.asarray(jtot[k][p]).tobytes()
                assert res[k].tobytes() == np.asarray(je[k][p]).tobytes()


# ---------------------------------------------------- profile_plan(shards=)

def test_profile_plan_shard_rows_match_reference():
    """``profile_plan(shards=2)`` adds one ``shard{p}/forward`` row per
    sub-plan after the forward and backward rows, as the reference does,
    with each shard's edges and tiles; no collective runs."""
    g, vals = gcn_edge_values(random_power_law(400, 6.0, seed=0))
    jp = j_plan_for(_jg(g), arch="gcn", in_dim=8, edge_vals=vals,
                    config=JAggConfig(**CFG), with_backward=True)
    tp = plan_for(g, arch="gcn", in_dim=8, edge_vals=vals,
                  config=AggConfig(**CFG), with_backward=True)
    jr = j_profile.profile_plan(jp, dim=8, shards=2, iters=2, warmup=1)
    tr = t_profile.profile_plan(tp, dim=8, shards=2, iters=2, warmup=1,
                                backend="torch", device="cpu")
    names = [s.schedule for s in tr.schedules]
    assert names == [s.schedule for s in jr.schedules] == [
        "forward", "backward", "shard0/forward", "shard1/forward"]
    for a, b in zip(tr.schedules, jr.schedules):
        assert (a.edges, a.tiles) == (b.edges, b.tiles)


# ---------------------------------------------------- the group

@pytest.mark.parametrize("how", ["raise", "hang"])
def test_failing_rank_tears_the_group_down(how):
    """A rank that raises, or hangs while its peer waits in a collective,
    makes the caller raise within the call's timeout; every rank process
    is gone afterwards and the group refuses further calls."""
    grp = RankGroup(2, device="cpu", timeout=4)
    pids = grp.run(_shard_ranks.r_pid)
    assert grp.run(_shard_ranks.r_fail_on, None, 7, "raise") == [2.0, 2.0]
    procs = list(grp._procs)
    with pytest.raises(RankError, match="torn down") as err:
        grp.run(_shard_ranks.r_fail_on, None, 1, how)
    if how == "raise":
        assert "fails on purpose" in str(err.value)
    assert not grp.alive
    assert all(not p.is_alive() for p in procs)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(RankError, match="closed"):
        grp.run(_shard_ranks.r_pid)


def test_large_arrays_cross_as_files():
    """An array of at least `SPILL_MIN_BYTES` travels as a file in the
    group's temporary directory, both ways, and comes back equal; no
    file is left behind."""
    from repro_torch.distributed.ranks import SPILL_MIN_BYTES
    grp = _group(2)
    big = np.random.default_rng(0).standard_normal(
        (SPILL_MIN_BYTES // 4 + 7,)).astype(np.float32)
    small = np.arange(5, dtype=np.int64)
    out = grp.run(_shard_ranks.r_echo, [(big,), (small,)])
    assert out[0].tobytes() == big.tobytes()
    np.testing.assert_array_equal(out[1], small)
    assert not [f for f in os.listdir(grp._tmp) if f.endswith(".npy")]


def test_nccl_with_too_few_cards_refuses():
    """NCCL needs one card per shard (`shard_mesh`'s refusal of too few
    devices): the message names ``--dist-backend gloo``; nothing falls
    back by itself."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for fn in (lambda: check_dist_backend("nccl", "cuda", have + 1),
               lambda: check_dist_backend("nccl", "cpu", 2),
               lambda: shard_group(2, device="cpu", dist_backend="nccl")):
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            fn()
    with pytest.raises(ValueError, match="unknown dist backend"):
        check_dist_backend("mpi", "cpu", 2)
