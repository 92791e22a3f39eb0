"""Port planner parity: the port's host-side planner (graphs, partition,
reorder, advisor, Plan npz) against the reference, plus the port's own
hardware model (H100 Eq. 4) and run structure.

Schedules are compared BIT-EQUAL under pinned configs: the planner is numpy
on both sides, so any difference is a porting fault."""
import dataclasses

import numpy as np
import pytest

import repro.core.advisor as j_advisor
import repro.core.partition as j_part
import repro.graphs.csr as j_csr
import repro.models.gnn as j_gnn
from repro.core.model import AggConfig as JAggConfig
from repro.core.plan import Plan as JPlan

import repro_torch.core.advisor as t_advisor
import repro_torch.core.partition as t_part
import repro_torch.graphs.csr as t_csr
from repro_torch.core.model import (AggConfig, config_infeasibility,
                                    smem_working_set)
from repro_torch.core.plan import Plan
from repro_torch.core.tuner import SEARCH_SPACE, tune
from repro_torch.hw import H100_SXM
from repro_torch.kernels.group_aggregate import VARIANTS, launch_geometry
from repro_torch.kernels.ops import DeviceSchedule, run_bounds
from repro_torch.models.gnn import gcn_edge_values

ARRAYS = ("nbrs", "edge_val", "local_node", "tile_node_block", "tile_window",
          "edge_slot", "edge_pos")
CONFIGS = [dict(gs=16, gpt=16, ont=8, src_win=512),
           dict(gs=4, gpt=8, ont=8, src_win=128),
           dict(gs=3, gpt=5, ont=4, src_win=64)]


def _graphs(n=300, deg=6.0, seed=1):
    return (j_csr.random_power_law(n, deg, seed=seed),
            t_csr.random_power_law(n, deg, seed=seed))


def _assert_same_partition(a, b):
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("gs", "gpt", "ont", "src_win", "num_nodes", "num_edges"):
        assert getattr(a, f) == getattr(b, f), f


def test_generators_bit_equal():
    gj, gt = _graphs()
    np.testing.assert_array_equal(gj.indptr, gt.indptr)
    np.testing.assert_array_equal(gj.indices, gt.indices)
    cj = j_csr.random_community_graph(6, 15, seed=3)
    ct = t_csr.random_community_graph(6, 15, seed=3)
    np.testing.assert_array_equal(cj.indices, ct.indices)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("valued", [False, True])
def test_partition_bit_equal(cfg, valued):
    gj, gt = _graphs()
    ev = (np.random.default_rng(0).standard_normal(gj.num_edges)
          .astype(np.float32) if valued else None)
    pj = j_part.partition_graph(gj, edge_vals=ev, **cfg)
    pt = t_part.partition_graph(gt, edge_vals=ev, **cfg)
    _assert_same_partition(pj, pt)
    target = 1 << (pj.num_tiles - 1).bit_length()
    _assert_same_partition(j_part.pad_partition_tiles(pj, target + 3),
                           t_part.pad_partition_tiles(pt, target + 3))


@pytest.mark.parametrize("arch", ["gcn", "gin"])
def test_plan_for_bit_equal_under_pinned_config(arch):
    gj, gt = _graphs(n=260, seed=4)
    vals = None
    if arch == "gcn":
        gj, vals = j_gnn.gcn_edge_values(gj)
        gt, vals_t = gcn_edge_values(gt)
        np.testing.assert_array_equal(vals, vals_t)
    cfg = dict(gs=8, gpt=16, dt=64, src_win=256, ont=8)
    pj = j_advisor.plan_for(gj, arch=arch, in_dim=12, hidden_dim=8,
                            edge_vals=vals, config=JAggConfig(**cfg))
    pt = t_advisor.plan_for(gt, arch=arch, in_dim=12, hidden_dim=8,
                            edge_vals=vals, config=AggConfig(**cfg))
    _assert_same_partition(pj.partition, pt.partition)
    assert pj.stats == pt.stats
    assert pj.reduce_dim_first == pt.reduce_dim_first
    assert dataclasses.asdict(pj.arch) == dataclasses.asdict(pt.arch)


def test_advise_same_perm():
    gj = j_csr.random_community_graph(10, 20, p_intra=0.4,
                                      p_inter_edges_per_node=0.3, seed=2)
    gt = t_csr.random_community_graph(10, 20, p_intra=0.4,
                                      p_inter_edges_per_node=0.3, seed=2)
    cfg = dict(gs=8, gpt=8, dt=64, src_win=128)
    pj = j_advisor.advise(gj, reorder="on", config=JAggConfig(**cfg))
    pt = t_advisor.advise(gt, reorder="on", config=AggConfig(**cfg))
    assert pj.perm is not None
    np.testing.assert_array_equal(pj.perm, pt.perm)
    np.testing.assert_array_equal(pj.graph.indices, pt.graph.indices)
    _assert_same_partition(pj.partition, pt.partition)


def test_reference_npz_loads_in_port(tmp_path):
    gj, _ = _graphs(n=200, seed=5)
    gj, vals = j_gnn.gcn_edge_values(gj)
    pj = j_advisor.plan_for(gj, arch="gcn", in_dim=8, hidden_dim=8,
                            edge_vals=vals, with_backward=True,
                            config=JAggConfig(gs=4, gpt=8, dt=16,
                                              src_win=128,
                                              feat_dtype="bfloat16"))
    path = str(tmp_path / "plan.npz")
    pj.save(path)
    pt = Plan.load(path)
    assert dataclasses.asdict(pt.config) == dataclasses.asdict(pj.config)
    _assert_same_partition(pj.partition, pt.partition)
    _assert_same_partition(pj.partition_bwd, pt.partition_bwd)
    np.testing.assert_array_equal(pj.edge_perm_bwd, pt.edge_perm_bwd)
    assert pt.fingerprint() == JPlan.load(path).fingerprint()
    # and back: the port's npz loads in the reference
    path2 = str(tmp_path / "plan_port.npz")
    pt.save(path2)
    _assert_same_partition(JPlan.load(path2).partition, pt.partition)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_each_node_block_forms_one_run(cfg):
    _, gt = _graphs(n=333, seed=6)
    p = t_part.partition_graph(gt, **cfg)
    p = t_part.pad_partition_tiles(p, 1 << p.num_tiles.bit_length())
    rs = run_bounds(p.tile_node_block)
    nb = p.tile_node_block
    blocks = nb[rs[:-1]]
    assert len(np.unique(blocks)) == len(blocks)        # one run per block
    for a, b in zip(rs[:-1], rs[1:]):
        assert (nb[a:b] == nb[a]).all()
    # the kernels launch runs over the live prefix: trailing pad tiles
    # (all on the last node block) hold no edge and are left out
    sched = DeviceSchedule(p, "cpu")
    live = sched.live_tiles
    assert live == int(p.edge_slot.max()) // p.gpt + 1 < p.num_tiles
    assert (p.edge_val[live:] == 0).all()
    np.testing.assert_array_equal(sched.run_start.numpy(),
                                  run_bounds(nb[:live]))
    assert sched.run_start[-1] == live


def test_run_bounds_rejects_split_block():
    with pytest.raises(ValueError, match="more than one run"):
        run_bounds(np.array([0, 0, 1, 0], np.int32))


def test_device_schedule_rejects_out_of_window_ids():
    _, gt = _graphs(n=200, seed=7)
    p = t_part.partition_graph(gt, gs=4, gpt=8, src_win=64)
    nbrs = p.nbrs.copy()
    nbrs[0, 0, 0] = (p.tile_window[0] + 1) * p.src_win
    with pytest.raises(ValueError, match="window"):
        DeviceSchedule(dataclasses.replace(p, nbrs=nbrs), "cpu")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
def test_tuner_returns_feasible_configs(variant, feat_dtype):
    _, gt = _graphs(n=400, seed=8)
    res = tune(gt, 64, iters=4, pop=8, feat_dtype=feat_dtype,
               variant=variant)
    for _, c in res.top + [(None, res.best)]:
        assert c.variant == variant and c.feat_dtype == feat_dtype
        assert config_infeasibility(c) is None
        assert smem_working_set(c) <= H100_SXM.smem_per_block


@pytest.mark.parametrize("variant", VARIANTS)
def test_eq4_prices_the_launch_over_the_search_space(variant):
    """Every config of the search space fits one block's shared memory, and
    Eq. 4 is exactly the launch's allocation (also at the narrower dim
    tiles a small feature width gives, which only shrink it)."""
    for gs in SEARCH_SPACE["gs"]:
        for gpt in SEARCH_SPACE["gpt"]:
            for dt in SEARCH_SPACE["dt"]:
                c = AggConfig(gs=gs, gpt=gpt, dt=dt, variant=variant)
                ws = smem_working_set(c)
                assert ws == launch_geometry(variant, gs=gs, gpt=gpt,
                                             ont=c.ont, dt=dt).smem_bytes
                assert ws <= H100_SXM.smem_per_block
                for dt_eff in (8, 16, dt // 2 or 8):
                    assert launch_geometry(variant, gs=gs, gpt=gpt, ont=8,
                                           dt=dt_eff).smem_bytes <= ws


def test_eq4_rejects_oversized_block():
    c = AggConfig(ont=4096, dt=512, variant="direct")
    assert "Eq. 4" in config_infeasibility(c)


@pytest.mark.parametrize("variant", ["folded", "slot_onehot"])
def test_onehot_launch_geometry_over_the_search_space(variant):
    """The one-hot kernels' launch at every config of the search space (and
    at the narrower dim tiles small widths give): fits one block's shared
    memory, is exactly Eq. 4, runs 8 warps and meets the kernel's TMA
    alignment (a stage's group rows span a multiple of 16 bytes)."""
    for gs in SEARCH_SPACE["gs"]:
        for gpt in SEARCH_SPACE["gpt"]:
            for dt in SEARCH_SPACE["dt"] + [8, 16, 24]:
                c = AggConfig(gs=gs, gpt=gpt, dt=dt, variant=variant)
                geo = launch_geometry(variant, gs=gs, gpt=gpt, ont=c.ont,
                                      dt=dt)
                assert geo.smem_bytes == smem_working_set(c)
                assert geo.smem_bytes <= H100_SXM.smem_per_block
                assert geo.smem_bytes % 16 == 0
                assert geo.warps == 8
                unit_groups = (32 // gs if gs <= 32 else 1)
                assert geo.stage_units * unit_groups % 4 == 0


def test_direct_launch_geometry_over_the_search_space():
    """The direct kernel's launch at every config of the search space (and
    at the narrower dim tiles small widths give) is exactly Eq. 4 and the
    kernel's `Layout`: column slices of up to 128 columns, four a lane,
    lanes per entry the slice row's four-column pieces to a power of two,
    one ont x dc f32 partial per warp and lane group and a 128-entry list
    (12 bytes an entry) per warp, 8 warps; it fits one block's shared
    memory for every feature dtype."""
    for gs in SEARCH_SPACE["gs"]:
        for gpt in SEARCH_SPACE["gpt"]:
            for dt in SEARCH_SPACE["dt"] + [8, 16, 24, 40]:
                for feat_dtype in ("float32", "bfloat16"):
                    c = AggConfig(gs=gs, gpt=gpt, dt=dt, variant="direct",
                                  feat_dtype=feat_dtype)
                    geo = launch_geometry("direct", gs=gs, gpt=gpt,
                                          ont=c.ont, dt=dt)
                    dc = min(dt, 128)
                    lanes = 1 << max(0, (-(-dc // 4) - 1).bit_length())
                    assert geo.dc == dc and geo.warps == 8
                    assert geo.smem_bytes == (4 * 8 * (32 // lanes) * c.ont
                                              * dc + 12 * 8 * 128)
                    assert geo.smem_bytes == smem_working_set(c)
                    assert geo.smem_bytes <= H100_SXM.smem_per_block


@pytest.mark.parametrize("variant", VARIANTS)
def test_pinned_config_outside_the_kernels_launch_limits(variant):
    """gpt 6 is no multiple of 4, which the one-hot kernels' metadata copies
    need: the feasibility check names it and `plan_for` refuses such a
    pinned config up front, while the direct kernel takes it."""
    g = t_csr.random_power_law(200, 4.0, seed=3)
    cfg = AggConfig(gs=4, gpt=6, dt=16, src_win=128, variant=variant)
    if variant == "direct":
        assert config_infeasibility(cfg) is None
        plan = t_advisor.plan_for(g, arch="gin", in_dim=8, hidden_dim=8,
                                  config=cfg)
        assert plan.config.gpt == 6
        return
    assert "gpt=6" in config_infeasibility(cfg)
    with pytest.raises(ValueError, match="gpt=6"):
        t_advisor.plan_for(g, arch="gin", in_dim=8, hidden_dim=8, config=cfg)
    ok = dataclasses.replace(cfg, gpt=8)
    assert config_infeasibility(ok) is None
    assert t_advisor.plan_for(g, arch="gin", in_dim=8, hidden_dim=8,
                              config=ok).config.gpt == 8


@pytest.mark.parametrize("variant,picked,tiles", [
    ("folded", (4, 8, 512, 2048), 25_117),
    ("slot_onehot", (4, 8, 512, 2048), 25_117)])
def test_planner_picks_on_the_pubmed_replica(variant, picked, tiles):
    """The pubmed replica's GCN schedules as the chip smoke test's phase 2
    plans them (in-dim and hidden 16, 4 tuner iterations): the picks and
    tile counts the one-hot kernels' times in PERF.md are read at.  The
    measured `KernelModel` prices every slot a run's walk reads, so the
    least padded config wins: the smallest groups and the widest window."""
    g, vals = gcn_edge_values(t_csr.random_power_law(19717, 4.5, seed=0))
    plan = t_advisor.plan_for(g, arch="gcn", in_dim=16, hidden_dim=16,
                              edge_vals=vals, tune_iters=4, variant=variant)
    assert plan.config.astuple()[:4] == picked
    assert plan.partition.num_tiles == tiles


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
def test_executor_from_schedule_matches_reference(variant, feat_dtype):
    """`PlanExecutor.from_schedule` over a plan's forward and transposed
    schedules equals the reference's `from_schedule` on the same features
    (the reference on "xla", the port on the plain version), and the
    forward one equals the plan's own executor; normalized 1e-5 (f32) /
    the bf16 output's rounding (2e-2)."""
    import jax.numpy as jnp
    import torch

    from repro.core.aggregate import PlanExecutor as JExecutor
    from repro_torch.core.aggregate import PlanExecutor

    gj, gt = _graphs()
    cfg = dict(gs=4, gpt=8, ont=8, src_win=128, dt=16, variant=variant,
               feat_dtype=feat_dtype)
    jp = j_advisor.plan_for(gj, arch="gcn", in_dim=16, hidden_dim=16,
                            config=JAggConfig(**cfg), with_backward=True)
    tp = t_advisor.plan_for(gt, arch="gcn", in_dim=16, hidden_dim=16,
                            config=AggConfig(**cfg), with_backward=True)
    x = np.random.default_rng(3).standard_normal(
        (gt.num_nodes, 16)).astype(np.float32)
    tol = 1e-5 if feat_dtype == "float32" else 2e-2
    for jsched, tsched in ((jp.sched(), tp.sched("cpu")),
                           (jp.sched_bwd(), tp.sched_bwd("cpu"))):
        jex = JExecutor.from_schedule(jsched, dt=16, variant=variant,
                                      backend="xla", out_dtype=feat_dtype)
        tex = PlanExecutor.from_schedule(tsched, dt=16, variant=variant,
                                         backend="torch", device="cpu",
                                         out_dtype=feat_dtype)
        assert tex.plan is None and tex.variant == variant
        ref = np.asarray(jex(jnp.asarray(x, jnp.dtype(feat_dtype))),
                         np.float32)
        got = tex(torch.as_tensor(x).to(getattr(torch, feat_dtype)))
        assert got.dtype == getattr(torch, feat_dtype)
        got = got.float().numpy()
        assert float((np.abs(got - ref) / (1 + np.abs(ref))).max()) <= tol
    own = tp.executor("torch", "cpu")(torch.as_tensor(x).to(
        getattr(torch, feat_dtype)))
    fwd = PlanExecutor.from_schedule(tp.sched("cpu"), dt=16, variant=variant,
                                     backend="torch", device="cpu",
                                     out_dtype=feat_dtype)
    assert torch.equal(own, fwd(torch.as_tensor(x).to(
        getattr(torch, feat_dtype))))


def test_kernel_costs_are_the_fit_of_their_recorded_points():
    """`KERNEL_COSTS` and `CALL_S` are what `tools/fit_kernel_costs.py`
    fits to the measurements in `tools/kernel_cost_points.json` (shipped to
    three significant figures: rtol 5e-3), and the shipped costs price
    every point within the 0.71-1.34x that `core/model.py` states."""
    import importlib.util
    import os

    from repro_torch.core.model import CALL_S, KERNEL_COSTS
    tools = os.path.join(os.path.dirname(__file__), "..", "tools")
    spec = importlib.util.spec_from_file_location(
        "fit_kernel_costs", os.path.join(tools, "fit_kernel_costs.py"))
    fkc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fkc)

    pts = fkc.load_points([os.path.join(tools, "kernel_cost_points.json")])
    res = fkc.fit(pts)
    assert len(pts) == 42
    np.testing.assert_allclose(res["call_s"], CALL_S, rtol=5e-3)
    for v, n in (("folded", 24), ("direct", 18)):
        assert res[v]["points"] == n
        for f in fkc.FITTED:
            np.testing.assert_allclose(getattr(res[v]["fitted"], f),
                                       getattr(KERNEL_COSTS[v], f),
                                       rtol=5e-3, err_msg=f"{v} {f}")
        rs = res[v]["ratios_shipped"]
        assert 0.71 <= min(rs) and max(rs) <= 1.34, (v, rs)
