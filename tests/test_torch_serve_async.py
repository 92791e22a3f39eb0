"""Port async serving tier parity: `repro_torch.serving` admission,
batchers, load generator and `AsyncServingEngine` against the reference's
`repro.serving` (mirrors `tests/test_serve_async.py`).

Four families: batcher and admission properties (the same close-time
invariants, and close times equal to the reference's on the same
queues); the load generator's schedule, arrival for arrival; exact
accounting under racing submitters, shutdown, queue-full and EDF; and
async logits against the port's synchronous engine and the reference's
async tier on carried weights, within the normalized 1e-5."""
import math
import threading
import time

import jax
import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

import repro.graphs.csr as j_csr
import repro.models.gnn as j_gnn
import repro.serving as j_serving
import repro_torch.serving as t_serving
from repro.serving.admission import AsyncRequest as JAsyncRequest

from repro_torch.graphs.csr import CSRGraph
from repro_torch.launch import serve_gnn
from repro_torch.models import gnn as t_gnn
from repro_torch.serving import (AdmissionQueue, AsyncRequest,
                                 AsyncServingEngine, ClockBatcher,
                                 DeadlineBatcher, LoadSpec, SLOClass,
                                 ServingConfig, ServingEngine, TenantSpec,
                                 build_schedule, run_schedule, slo_classes)


def _req(rid, t_submit, deadline, tenant="t", cls=AsyncRequest):
    return cls(rid=rid, tenant=tenant, seed=rid, t_submit=t_submit,
               deadline=deadline)


def _echo_fn(delay=0.0):
    """serve_fn stub: returns each seed as a 1-wide logit row."""
    def fn(seeds):
        if delay:
            time.sleep(delay)
        return np.asarray(list(seeds), np.float32).reshape(-1, 1)
    return fn


def _nerr(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b))
                  / (1.0 + np.abs(np.asarray(b)))).max())


# ------------------------------------------------------- admission / SLO

def test_slo_classes_match_reference():
    for base in (0.1, 0.25, 1.0):
        assert [(c.name, c.slo_s) for c in slo_classes(base)] == [
            (c.name, c.slo_s) for c in j_serving.slo_classes(base)]
    with pytest.raises(ValueError):
        SLOClass("bad", 0.0)


def test_admission_queue_rejects_in_order():
    q = AdmissionQueue("t", capacity=2, slo=SLOClass("gold", 0.1))
    r = _req(0, 0.0, 0.1)
    assert q.admit(r, depth=0, closed=True, now=0.0) == "closed"
    assert r.status == "rejected" and r.reject_reason == "closed"
    r2 = _req(1, 0.0, 0.1)
    assert q.admit(r2, depth=2, closed=False, now=0.0) == "queue_full"
    r3 = _req(2, 0.0, 0.1)
    assert q.admit(r3, depth=1, closed=False, now=0.0) is None
    assert r3.status == "pending"
    assert (q.submitted, q.completed, q.rejected, q.accounted) == (3, 0, 2, 2)


# ------------------------------------------------- batcher property tests

@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 24), slo_ms=st.floats(1.0, 500.0),
       est_ms=st.floats(0.0, 50.0), margin_ms=st.floats(0.0, 10.0),
       gap_ms=st.floats(0.1, 50.0), seed=st.integers(0, 10_000))
def test_prop_deadline_close_matches_reference(n, slo_ms, est_ms, margin_ms,
                                               gap_ms, seed):
    """The same queue in both packages' `DeadlineBatcher`: equal close
    times (with and without an idle gap), and the invariant
    close_at + est + margin <= min(deadline)."""
    rng = np.random.default_rng(seed)
    mk = dict(max_batch=1024, est_fn=lambda: est_ms / 1e3,
              margin=margin_ms / 1e3)
    ours = [DeadlineBatcher(idle_gap=None, **mk),
            DeadlineBatcher(idle_gap=gap_ms / 1e3, **mk)]
    ref = [j_serving.DeadlineBatcher(idle_gap=None, **mk),
           j_serving.DeadlineBatcher(idle_gap=gap_ms / 1e3, **mk)]
    t = 0.0
    for i in range(n):
        t += float(rng.uniform(0.0, 0.01))
        dl = t + slo_ms / 1e3 * float(rng.uniform(0.5, 1.5))
        for b in ours:
            b.put(_req(i, t, dl), now=t)
        for b in ref:
            b.put(_req(i, t, dl, cls=JAsyncRequest), now=t)
    for a, b in zip(ours, ref):
        assert a.close_at(t) == b.close_at(t)
        assert a.oldest_deadline() == b.oldest_deadline()
        assert a.due(t) == b.due(t)
    assert (ours[0].close_at(t) + est_ms / 1e3 + margin_ms / 1e3
            <= ours[0].oldest_deadline() + 1e-12)
    assert ours[1].close_at(t) <= t + gap_ms / 1e3 + 1e-12


@settings(max_examples=25, deadline=None)
@given(n=st.integers(0, 100), max_batch=st.sampled_from([1, 2, 4, 8, 16, 32]),
       policy=st.booleans())
def test_prop_pop_caps_size_and_keeps_fifo(n, max_batch, policy):
    b = (DeadlineBatcher(max_batch=max_batch)
         if policy else ClockBatcher(max_batch=max_batch, window=0.01))
    for i in range(n):
        b.put(_req(i, float(i), float(i) + 1.0), now=float(i))
    popped = []
    while b.pending():
        batch = b.pop(float(n))
        assert 1 <= len(batch) <= max_batch
        popped.extend(r.rid for r in batch)
    assert popped == list(range(n))
    assert b.pop(float(n)) == [] and not b.due(float(n))


@settings(max_examples=25, deadline=None)
@given(window_ms=st.floats(0.0, 200.0), dt_ms=st.floats(0.0, 400.0),
       seed=st.integers(0, 10_000))
def test_prop_clock_window_matches_reference(window_ms, dt_ms, seed):
    rng = np.random.default_rng(seed)
    t0 = float(rng.uniform(0.0, 5.0))
    ours = ClockBatcher(max_batch=64, window=window_ms / 1e3)
    ref = j_serving.ClockBatcher(max_batch=64, window=window_ms / 1e3)
    for b, cls in ((ours, AsyncRequest), (ref, JAsyncRequest)):
        b.put(_req(0, t0, t0 + 1.0, cls=cls), now=t0)
        b.put(_req(1, t0 + 0.001, t0 + 1.0, cls=cls), now=t0 + 0.001)
    assert ours.close_at(t0) == ref.close_at(t0) == t0 + window_ms / 1e3
    now = t0 + dt_ms / 1e3
    assert ours.due(now) == ref.due(now) == (now >= t0 + window_ms / 1e3)


def test_deadline_estimate_clamps_garbage():
    for bad in (math.nan, math.inf, -1.0):
        b = DeadlineBatcher(max_batch=4, est_fn=lambda v=bad: v)
        assert b.estimate() == 0.0
    assert DeadlineBatcher(max_batch=4, est_fn=lambda: 0.25).estimate() == 0.25
    with pytest.raises(ValueError):
        DeadlineBatcher(max_batch=4, margin=-1.0)
    with pytest.raises(ValueError):
        ClockBatcher(max_batch=0, window=0.1)


# ----------------------------------------------------------- load generator

@pytest.mark.parametrize("spec", [
    dict(requests=64, rate_rps=1000.0, tenants=("a", "b"), seed=3),
    dict(requests=40, rate_rps=math.inf, tenants=("t0", "t1", "t2"), seed=0),
    dict(requests=33, rate_rps=250.0, arrival="poisson", zipf=1.3,
         hot_fraction=0.1, tenants=("x",), seed=9),
], ids=["uniform", "burst", "poisson"])
def test_build_schedule_matches_reference(spec):
    ours = build_schedule(500, LoadSpec(**spec))
    ref = j_serving.build_schedule(500, j_serving.LoadSpec(**spec))
    assert [(a.t, a.tenant, a.seed) for a in ours] == [
        (a.t, a.tenant, a.seed) for a in ref]
    assert ours == build_schedule(500, LoadSpec(**spec))


def test_build_schedule_arrival_processes():
    burst = build_schedule(100, LoadSpec(requests=16, rate_rps=math.inf))
    assert all(a.t == 0.0 for a in burst)
    uni = build_schedule(100, LoadSpec(requests=16, rate_rps=100.0))
    np.testing.assert_allclose([a.t for a in uni], np.arange(16) / 100.0)
    with pytest.raises(ValueError):
        LoadSpec(requests=0)
    with pytest.raises(ValueError):
        LoadSpec(arrival="bursty")


# ----------------------------------------------------- concurrency stress

def test_stress_exact_accounting_across_threads():
    """8 submitter threads x 3 tenants; every request terminal after
    drain, accounting exact, every result row equals its seed."""
    eng = AsyncServingEngine(
        [TenantSpec(f"t{i}", _echo_fn(0.0005), slo=SLOClass("gold", 2.0),
                    max_batch=16) for i in range(3)],
        idle_gap=0.002)
    per_thread, threads, all_reqs = 40, 8, []
    lock = threading.Lock()

    def submitter(k):
        rs = [eng.submit(k * per_thread + j, tenant=f"t{(k + j) % 3}")
              for j in range(per_thread)]
        with lock:
            all_reqs.extend(rs)

    ts = [threading.Thread(target=submitter, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert eng.drain(timeout=30.0)
    acc = eng.accounting()
    assert acc["submitted"] == threads * per_thread
    assert acc["submitted"] == acc["completed"] + acc["rejected"]
    assert acc["outstanding"] == 0
    assert all(r.terminal for r in all_reqs)
    for r in all_reqs:
        if r.status == "done":
            assert float(r.result[0]) == float(r.seed)
    assert eng.close()


def test_shutdown_mid_flight_never_deadlocks_or_drops():
    eng = AsyncServingEngine(
        [TenantSpec("t", _echo_fn(0.01), slo=SLOClass("gold", 5.0),
                    max_batch=4)])
    reqs = [eng.submit(i) for i in range(60)]
    time.sleep(0.02)
    t0 = time.perf_counter()
    eng.close(drain=False, timeout=5.0)
    assert time.perf_counter() - t0 < 5.0
    for r in reqs:
        assert r.wait(2.0), f"request {r.rid} never became terminal"
    acc = eng.accounting()
    assert acc["submitted"] == acc["completed"] + acc["rejected"] == 60
    assert all(r.reject_reason == "shutdown" for r in reqs
               if r.status == "rejected")


def test_close_timeout_rejects_queued_and_submit_after_close():
    eng = AsyncServingEngine([TenantSpec("t", _echo_fn(0.5), max_batch=1)])
    reqs = [eng.submit(i) for i in range(5)]
    assert eng.close(drain=True, timeout=0.1) is False
    for r in reqs:
        assert r.wait(3.0)
    assert sum(r.status == "rejected" for r in reqs) >= 3
    acc = eng.accounting()
    assert acc["submitted"] == acc["completed"] + acc["rejected"] == 5
    r = eng.submit(0)
    assert r.status == "rejected" and r.reject_reason == "closed"


def test_queue_full_rejection_is_deterministic():
    eng = AsyncServingEngine(
        [TenantSpec("t", _echo_fn(), queue_cap=4)], start=False)
    reqs = [eng.submit(i) for i in range(10)]
    rejected = [r for r in reqs if r.status == "rejected"]
    assert len(rejected) == 6
    assert all(r.reject_reason == "queue_full" for r in rejected)
    assert eng.close()
    assert eng.accounting() == {"submitted": 10, "completed": 0,
                                "rejected": 10, "outstanding": 0}


def test_serve_fn_error_rejects_whole_batch():
    def boom(seeds):
        raise RuntimeError("kernel failed")
    eng = AsyncServingEngine([TenantSpec("t", boom, max_batch=4)],
                             idle_gap=0.001)
    reqs = [eng.submit(i) for i in range(6)]
    assert eng.drain(timeout=10.0) and eng.close()
    assert all(r.status == "rejected" and r.reject_reason == "error"
               for r in reqs)
    assert eng.accounting()["rejected"] == 6


def test_edf_gold_tenant_overtakes_bronze_flood():
    eng = AsyncServingEngine(
        [TenantSpec("gold", _echo_fn(0.005), slo=SLOClass("gold", 0.05),
                    max_batch=4),
         TenantSpec("bronze", _echo_fn(0.005), slo=SLOClass("bronze", 30.0),
                    max_batch=2)],
        idle_gap=0.002)
    flood = [eng.submit(i, tenant="bronze") for i in range(30)]
    g = eng.submit(999, tenant="gold")
    assert g.wait(5.0) and g.status == "done"
    done_before_gold = sum(1 for r in flood
                           if r.terminal and r.t_done <= g.t_done)
    assert done_before_gold <= len(flood) // 2
    assert eng.drain(timeout=30.0)
    assert eng.close()


def test_update_graph_between_batches_and_handler_resolution():
    """Updates run on the worker between fired batches, every admitted
    request completes, handlers are deduplicated, and a tenant without a
    handler is refused by name."""
    seen = []

    class Exec:
        def __call__(self, seeds):
            return _echo_fn(0.001)(seeds)

        def update_graph(self, delta):
            seen.append(delta)

    ex = Exec()
    eng = AsyncServingEngine([TenantSpec("a", ex, max_batch=4),
                              TenantSpec("b", ex, max_batch=4),
                              TenantSpec("c", _echo_fn())], idle_gap=0.002)
    reqs = [eng.submit(i, tenant="ab"[i % 2]) for i in range(20)]
    assert eng.update_graph("d1").wait(10.0)
    reqs += [eng.submit(i, tenant="a") for i in range(5)]
    with pytest.raises(ValueError, match="no graph-update handler"):
        eng.update_graph("d2", tenant="c")
    assert eng.drain(timeout=10.0) and eng.close()
    assert seen == ["d1"]
    assert all(r.status == "done" for r in reqs)
    assert eng.registry.counter("serve_graph_updates_total").value == 1


def test_run_schedule_replay_accounts_exactly():
    eng = AsyncServingEngine([TenantSpec("a", _echo_fn()),
                              TenantSpec("b", _echo_fn())], idle_gap=0.002)
    sched = build_schedule(100, LoadSpec(requests=40, rate_rps=4000.0,
                                         tenants=("a", "b"), seed=1))
    res = run_schedule(eng, sched, drain_timeout=30.0)
    assert res["drained"] and res["completed"] == res["requests"] == 40
    assert [r.seed for r in res["requests_detail"]] == [a.seed for a in sched]
    assert eng.close()


# ------------------------------------------------------------- integration

@pytest.fixture(scope="module")
def engines():
    """The reference's and the port's synchronous GCN engines on one graph,
    features and carried parameters."""
    jg = j_csr.random_power_law(300, 6.0, seed=1)
    g = CSRGraph(jg.indptr, jg.indices)
    feat = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 8)).astype(np.float32)
    jcfg = j_gnn.GNNConfig(arch="gcn", in_dim=8, hidden_dim=8, num_classes=3,
                           backend="xla")
    tcfg = t_gnn.GNNConfig(arch="gcn", in_dim=8, hidden_dim=8, num_classes=3,
                           backend="torch", device="cpu")
    params = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(0))
    jeng = j_serving.ServingEngine(
        jg, feat, jcfg, params=params,
        serving=j_serving.ServingConfig(max_batch=8, tune_iters=2, jit=False))
    teng = ServingEngine(
        g, feat, tcfg, params=t_gnn.params_from_jax(
            {k: np.asarray(v) for k, v in params.items()}, "cpu"),
        serving=ServingConfig(max_batch=8, tune_iters=2))
    return g, jeng, teng


def test_async_matches_sync_and_reference_async(engines):
    """The same schedule through both packages' async tiers: every request
    done, async vs single-request port inference and vs the reference's
    async results within the normalized 1e-5."""
    g, jeng, teng = engines
    spec = dict(requests=24, rate_rps=2000.0, tenants=("t0", "t1", "t2"),
                seed=4)
    results = []
    for pkg, eng_sync in ((j_serving, jeng), (t_serving, teng)):
        classes = pkg.slo_classes(0.25)
        eng = pkg.AsyncServingEngine(
            [pkg.TenantSpec(f"t{i}", eng_sync.serve_batch, slo=classes[i],
                            max_batch=8) for i in range(3)],
            idle_gap=0.005)
        sched = pkg.build_schedule(g.num_nodes, pkg.LoadSpec(**spec))
        res = pkg.run_schedule(eng, sched, drain_timeout=120.0)
        assert res["drained"] and eng.close()
        acc = eng.accounting()
        assert acc["submitted"] == acc["completed"] == 24
        assert acc["outstanding"] == 0
        results.append(res["requests_detail"])
    jreqs, treqs = results
    assert [r.seed for r in jreqs] == [r.seed for r in treqs]
    for a, b in zip(treqs, jreqs):
        assert a.status == b.status == "done"
        assert _nerr(a.result, b.result) <= 1e-5
    for r in treqs[:6]:
        assert _nerr(r.result, teng.serve_batch([r.seed])[0]) <= 1e-5


def test_async_update_graph_resolves_bound_serving_engine(engines):
    """A tenant serving through `ServingEngine.serve_batch` swaps that
    engine's graph on `update_graph` (no explicit handler), and results
    after the swap equal a fresh engine on the mutated graph."""
    from repro_torch.graphs.datasets import interaction_stream
    g, jeng, teng = engines
    eng_sync = ServingEngine(g, teng.feat, teng.cfg, params=teng.params,
                             serving=ServingConfig(max_batch=8, tune_iters=2))
    delta = next(interaction_stream(g, num_batches=1, edges_per_batch=40,
                                    feat_dim=8, seed=1))
    eng = AsyncServingEngine([TenantSpec("t", eng_sync.serve_batch,
                                         max_batch=8)], idle_gap=0.002)
    first = [eng.submit(s) for s in range(5)]
    assert eng.update_graph(delta).wait(30.0)
    seeds = [0, 7, g.num_nodes, 150]                # a new node included
    after = [eng.submit(s) for s in seeds]
    assert eng.drain(timeout=60.0) and eng.close()
    assert all(r.status == "done" for r in first + after)
    assert eng_sync.graph_epoch == 1
    fresh = ServingEngine(g.apply_delta(delta).graph, eng_sync.feat,
                          teng.cfg, params=teng.params,
                          serving=ServingConfig(tune_iters=2))
    ref = fresh.serve_batch(seeds)
    for i, r in enumerate(after):
        assert _nerr(r.result, ref[i]) <= 1e-5


def test_driver_async_deadline_tenants_stream_deltas():
    """`serve_gnn --policy deadline --tenants 3 --stream-deltas 2` on the
    CPU: exact accounting, both deltas applied, verify within 1e-5."""
    res = serve_gnn.run(["--policy", "deadline", "--tenants", "3",
                         "--stream-deltas", "2", "--smoke", "--device", "cpu",
                         "--backend", "torch"])
    assert res["ok"]
    acc = res["accounting"]
    assert acc["submitted"] == acc["completed"] == 24
    assert acc["rejected"] == 0 and acc["outstanding"] == 0
    assert res["updates"] == 2 and res["update_errors"] == 0
    assert res["engine"].graph_epoch == 2
    assert res["verify_err"] <= 1e-5
    assert set(res["summary"]) == {"t0", "t1", "t2"}
    assert [s["slo_class"] for s in res["summary"].values()] == [
        "gold", "silver", "bronze"]


@pytest.mark.parametrize("flags,msg", [
    (["--shards", "2"], "Queue 1 item 5"),
])
def test_driver_refuses_unported_flags(flags, msg, capsys):
    with pytest.raises(SystemExit):
        serve_gnn.parse_args(["--smoke"] + flags)
    assert msg in capsys.readouterr().err


def test_driver_policy_selection():
    a = serve_gnn.parse_args(["--tenants", "3"])
    assert a.use_async and a.policy == "deadline" and a.slo_ms == 250.0
    b = serve_gnn.parse_args(["--slo-ms", "100"])
    assert b.use_async and b.policy == "deadline"
    c = serve_gnn.parse_args(["--policy", "clock"])
    assert c.use_async and c.policy == "clock"
    assert not serve_gnn.parse_args([]).use_async


def test_driver_async_needs_cuda_unless_cpu_asked():
    """Without ``--device cpu`` the async tier runs on the card and, on a
    machine without one, raises before it serves anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gnn.run(["--policy", "deadline", "--tenants", "3",
                       "--stream-deltas", "2", "--smoke"])


def test_driver_delta_chunks_replay_from_their_first_arrival(monkeypatch):
    """With --stream-deltas each chunk of the schedule is replayed from its
    own first arrival, keeping the gaps inside it: no chunk idles through
    the span of the chunks before it."""
    chunks = []
    real = t_serving.run_schedule

    def spy(engine, schedule, **kw):
        chunks.append(list(schedule))
        return real(engine, schedule, **kw)

    monkeypatch.setattr(t_serving, "run_schedule", spy)
    argv = ["--policy", "deadline", "--tenants", "3", "--stream-deltas", "2",
            "--rate", "400", "--smoke", "--device", "cpu", "--backend",
            "torch"]
    assert serve_gnn.run(argv)["ok"]
    full = build_schedule(1500, LoadSpec(
        requests=24, rate_rps=400.0, zipf=1.1,
        tenants=("t0", "t1", "t2"), seed=0))
    assert len(chunks) == 3 and sum(map(len, chunks)) == 24
    start = 0
    for chunk in chunks:
        orig = full[start:start + len(chunk)]
        assert chunk[0].t == 0.0
        assert [(a.seed, a.tenant) for a in chunk] == [
            (a.seed, a.tenant) for a in orig]
        np.testing.assert_allclose([a.t for a in chunk],
                                   [a.t - orig[0].t for a in orig])
        start += len(chunk)
