"""Port parity of the advisor's original-order path, community profiling,
the straggler policy and int8 error-feedback compression, against
`repro.core.aggregate.PlanExecutor.aggregate_original_order`,
`repro.core.tuner.community_profile`, `repro.runtime.straggler` and
`repro.optim.compression` on the same inputs (made with numpy from a
seed); mirrors `tests/test_reorder_advisor.py`, `tests/test_runtime.py`
and `tests/test_losses_optim.py`.

Tolerances, stated per test:
  * renumber permutations, community graphs, tile counts, straggler
    decisions and int8 codes / scales / residuals: bit-equal (the same
    numpy code, or float32 operations rounded once each);
  * aggregation in the original order vs the reference's ``xla`` backend
    and vs a dense scatter of the raw graph: ``max|a-b| / (1 + |b|)`` <=
    1e-5 (float32 summation order differs between schedules);
  * error-feedback convergence: the reference test's ``atol`` 5e-2.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
import repro.optim.compression as j_comp
import repro.runtime.straggler as j_strag
from repro.core.advisor import advise as j_advise
from repro.core.aggregate import PlanExecutor as JPlanExecutor
from repro.core.model import AggConfig as JAggConfig
from repro.core.partition import partition_graph as j_partition_graph
from repro.core.reorder import renumber as j_renumber
from repro.core.tuner import community_profile as j_community_profile

from repro_torch.core.advisor import advise
from repro_torch.core.aggregate import PlanExecutor
from repro_torch.core.model import AggConfig
from repro_torch.core.partition import partition_graph
from repro_torch.core.reorder import renumber
from repro_torch.core.tuner import community_profile
from repro_torch.graphs.csr import random_community_graph, random_power_law
from repro_torch.models.gnn import gcn_edge_values
from repro_torch.optim import (compress_decompress, dequantize_int8, ef_init,
                               quantize_int8)
from repro_torch.runtime import (HostDecision, StragglerMonitor,
                                 StragglerPolicy)

TOL = 1e-5
CFG = dict(gs=8, gpt=8, dt=16, src_win=64, ont=8)


def _nerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _jg(g):
    return j_csr.CSRGraph(g.indptr, g.indices)


# ------------------------------------------------ original-order aggregation

GRAPHS = {"community": lambda: random_community_graph(40, 12, seed=3),
          "power-law": lambda: random_power_law(400, 6.0, seed=3)}


@pytest.mark.parametrize("reorder", ["on", "off"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_aggregate_original_order_matches_reference(graph, reorder):
    """GIN (unit edge values) through ``advise``: the renumbered plan's
    permutation is the reference's, not the identity and not its own
    inverse, so a swap of ``perm`` and its inverse shows; the output in
    the caller's order equals the reference's ``xla`` executor and a
    dense scatter of the raw graph."""
    g = GRAPHS[graph]()
    plan = advise(g, arch="gin", in_dim=16, hidden_dim=16, reorder=reorder,
                  config=AggConfig(**CFG))
    jplan = j_advise(_jg(g), arch="gin", in_dim=16, hidden_dim=16,
                     reorder=reorder, config=JAggConfig(**CFG))
    n = g.num_nodes
    if reorder == "on":
        np.testing.assert_array_equal(plan.perm, jplan.perm)
        assert not np.array_equal(plan.perm, np.arange(n))
        assert not np.array_equal(plan.perm[plan.perm], np.arange(n))
    else:
        assert plan.perm is None and jplan.perm is None
    feat = np.random.default_rng(0).standard_normal((n, 16)).astype(
        np.float32)
    out = PlanExecutor(plan, backend="torch", device="cpu") \
        .aggregate_original_order(torch.from_numpy(feat)).numpy()
    ref = np.asarray(JPlanExecutor(jplan, backend="xla")
                     .aggregate_original_order(jnp.asarray(feat)))
    rows, cols = g.to_coo()
    dense = np.zeros((n, 16), np.float64)
    np.add.at(dense, rows, feat[cols])
    assert out.shape == (n, 16)
    assert _nerr(out, ref) <= TOL
    assert _nerr(out, dense) <= TOL
    if reorder == "on":
        # the executor in the plan's order, entered and left the wrong way
        inner = PlanExecutor(plan, backend="torch", device="cpu")
        inv = np.argsort(plan.perm)
        swapped = inner(torch.from_numpy(feat[plan.perm])).numpy()[inv]
        assert _nerr(swapped, dense) > 1e-2


def test_original_order_without_perm_and_from_schedule():
    """No permutation (a `plan_for` plan; a bare-schedule executor): the
    original-order entry is the plain call."""
    from repro_torch.core.advisor import plan_for
    g = random_power_law(300, 5.0, seed=1)
    plan = plan_for(g, arch="gin", in_dim=8, hidden_dim=8,
                    config=AggConfig(**CFG))
    ex = PlanExecutor(plan, backend="torch", device="cpu")
    bare = PlanExecutor.from_schedule(plan.sched("cpu"), dt=plan.config.dt,
                                      variant=plan.config.variant,
                                      backend="torch", device="cpu")
    feat = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (g.num_nodes, 8)).astype(np.float32))
    want = ex(feat)
    assert torch.equal(ex.aggregate_original_order(feat), want)
    assert torch.equal(bare.aggregate_original_order(feat), want)


def test_renumber_is_identity_with_self_loops():
    """Witness on both packages: `renumber` keeps every node in place on a
    graph that carries a self-loop on every node (GCN's A + I), so GCN's
    renumbering through ``advise`` is a no-op; the raw graph does move."""
    for make in GRAPHS.values():
        raw = make()
        loops, _ = gcn_edge_values(raw)
        n = raw.num_nodes
        np.testing.assert_array_equal(renumber(loops), np.arange(n))
        np.testing.assert_array_equal(j_renumber(_jg(loops)), np.arange(n))
        moved = renumber(raw)
        np.testing.assert_array_equal(moved, j_renumber(_jg(raw)))
        assert (moved == np.arange(n)).mean() < 0.5


# ------------------------------------------------------- community profiling

PROFILE_CONFIGS = [dict(gs=8, gpt=16, dt=64, src_win=128),
                   dict(gs=64, gpt=128, dt=512, src_win=2048)]


def test_community_profile_graphs_and_tiles_match_reference():
    """The reference test's sizes, dim and seed: the same synthetic
    graphs and, under its two configs, the same exact tile counts; the
    port prices them with its own `KernelModel`, so only finiteness and
    sign of the score are shared."""
    score = community_profile([16, 32], dim=32, seed=0)
    jscore = j_community_profile([16, 32], dim=32, seed=0)
    graphs = inspect.getclosurevars(score).nonlocals["graphs"]
    jgraphs = inspect.getclosurevars(jscore).nonlocals["graphs"]
    assert len(graphs) == len(jgraphs) == 6
    for g, jg in zip(graphs, jgraphs):
        np.testing.assert_array_equal(g.indptr, jg.indptr)
        np.testing.assert_array_equal(g.indices, jg.indices)
    for knobs in PROFILE_CONFIGS:
        cfg = AggConfig(**knobs)
        part_kw = dict(gs=cfg.gs, gpt=cfg.gpt, ont=cfg.ont,
                       src_win=cfg.src_win)
        for g, jg in zip(graphs, jgraphs):
            assert (partition_graph(g, **part_kw).num_tiles
                    == j_partition_graph(jg, **part_kw).num_tiles)
        s = score(cfg)
        assert s > 0 and np.isfinite(s)
        assert np.isfinite(jscore(JAggConfig(**knobs)))


# ----------------------------------------------------------------- stragglers

def _scripted(kind):
    """(num_hosts, policy kwargs, durations per step)."""
    if kind == "persistent":
        steps = []
        for _ in range(6):
            d = np.ones(8)
            d[3] = 5.0
            steps.append(d)
        return 8, dict(threshold=1.5, patience=2, deadline_factor=2.0,
                       evict_after=2), steps
    if kind == "transient":
        steps = []
        for i in range(6):
            d = np.ones(4)
            if i == 2:
                d[1] = 4.0
            steps.append(d)
        return 4, dict(patience=3), steps
    rng = np.random.default_rng(11)
    steps = []
    for i in range(40):
        d = rng.lognormal(0.0, 0.25, 6)
        if 10 <= i < 25:
            d[2] *= 3.0                      # a slow window on host 2
        if i % 7 == 3:
            d[int(rng.integers(0, 6))] *= 5.0   # hiccups
        steps.append(d)
    return 6, dict(threshold=1.4, patience=2, evict_after=3, ema=0.4), steps


@pytest.mark.parametrize("kind", ["persistent", "transient", "random"])
def test_straggler_decisions_match_reference(kind):
    hosts, kw, steps = _scripted(kind)
    mon = StragglerMonitor(hosts, StragglerPolicy(**kw))
    jmon = j_strag.StragglerMonitor(hosts, j_strag.StragglerPolicy(**kw))
    for i, d in enumerate(steps):
        feed = ({h: float(x) for h, x in enumerate(d)} if i % 2 else d)
        dec, jdec = mon.observe(feed), jmon.observe(feed)
        assert all(isinstance(x, HostDecision) for x in dec)
        assert ([dataclasses.asdict(x) for x in dec]
                == [dataclasses.asdict(x) for x in jdec])
        assert (mon.effective_step_time(d, dec)
                == jmon.effective_step_time(d, jdec))
        assert mon.gradient_scale(dec) == jmon.gradient_scale(jdec)
    if kind == "persistent":
        assert dec[3].straggler and dec[3].propose_evict
        assert dec[3].skip_this_step
        assert not any(x.straggler for x in dec if x.host != 3)
        assert mon.effective_step_time(d, dec) == pytest.approx(1.0)
        assert mon.gradient_scale(dec) == pytest.approx(8 / 7)
    if kind == "transient":
        assert not dec[1].straggler
    if kind == "random":
        assert any(x[2].straggler for x in mon.history)
    # without decisions, effective_step_time observes the durations itself
    d = steps[-1]
    assert mon.effective_step_time(d) == jmon.effective_step_time(d)


# ---------------------------------------------------------------- compression

def test_quantize_bit_equal_with_half_ties():
    """Codes, scale and round trip bit-equal to the reference; ``x /
    scale`` lands exactly on .5 for four entries (scale 1.0), which both
    round half to even."""
    x = np.array([127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.4], np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and float(s) == 1.0
    np.testing.assert_array_equal(q.numpy(), [127, 2, -4, 0, 2, 0, 126])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    rng = np.random.default_rng(4)
    for shape in [(128,), (33, 17), (4, 8, 5)]:
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        q, s = quantize_int8(torch.from_numpy(x))
        jq, js = j_comp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        deq = dequantize_int8(q, s).numpy()
        assert deq.tobytes() == np.asarray(
            j_comp.dequantize_int8(jq, js)).tobytes()
        # the reference test's round-trip bound
        assert np.abs(deq - x).max() <= float(s) * 0.51 + 1e-6
    # bfloat16 input is quantized from its float32 value
    xb = torch.from_numpy(x).to(torch.bfloat16)
    qb, _ = quantize_int8(xb)
    jqb, _ = j_comp.quantize_int8(jnp.asarray(xb.float().numpy(),
                                              jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))


def test_error_feedback_sequence_bit_equal():
    """50 error-feedback steps on seeded gradients: every g_hat and every
    residual bit-equal to the reference's."""
    rng = np.random.default_rng(7)
    e = torch.zeros(64)
    je = jnp.zeros(64)
    for _ in range(50):
        g = (rng.standard_normal(64) * rng.uniform(0.01, 10)).astype(
            np.float32)
        g_hat, e = compress_decompress(torch.from_numpy(g), e)
        jg_hat, je = j_comp.compress_decompress(jnp.asarray(g), je)
        assert g_hat.numpy().tobytes() == np.asarray(jg_hat).tobytes()
        assert e.numpy().tobytes() == np.asarray(je).tobytes()


def test_ef_init_tree_order():
    """Zero float32 accumulators over a nested dict / list tree, leaf by
    leaf in `jax.tree_util`'s order, shaped like the reference's."""
    rng = np.random.default_rng(0)
    arrs = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "blocks": [{"b": np.ones(5, np.float16),
                        "a": np.zeros((2, 2), np.float32)},
                       {"b": np.ones(6, np.float16),
                        "a": np.zeros((1, 2), np.float32)}],
            "embed": rng.standard_normal(7).astype(np.float32)}
    tree = jax.tree.map(torch.from_numpy, arrs)
    ef = ef_init(tree)
    jef = j_comp.ef_init(jax.tree.map(jnp.asarray, arrs))
    assert list(ef) == list(tree) and len(ef["blocks"]) == 2
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), ef))
    jleaves = jax.tree.leaves(jef)
    assert len(leaves) == len(jleaves) == 6
    for a, b in zip(leaves, jleaves):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert not a.any()


def test_error_feedback_convergence():
    """SGD with int8 EF compression converges on a quadratic bowl (the
    reference's test, on tensors)."""
    target = torch.tensor([0.3, -1.7, 2.2, 0.01])
    w = torch.zeros(4)
    e = torch.zeros(4)
    for _ in range(400):
        g = 2 * (w - target)
        g_hat, e = compress_decompress(g, e)
        w = w - 0.05 * g_hat
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=5e-2)


def test_error_feedback_beats_plain_quantization():
    target = torch.tensor([1e-3, 2e-3, -1e-3, 5.0])

    def run(use_ef):
        w = torch.zeros(4)
        e = torch.zeros(4)
        for _ in range(300):
            g = 2 * (w - target)
            if use_ef:
                g_hat, e = compress_decompress(g, e)
            else:
                q, s = quantize_int8(g)
                g_hat = dequantize_int8(q, s)
            w = w - 0.05 * g_hat
        return float((w - target).abs().max())
    assert run(True) <= run(False) + 1e-6
