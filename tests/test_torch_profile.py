"""Port profiling tier parity: `repro_torch.obs.profile` (`Measurement`,
`measure`, `profile_plan`), the measured tuner stage
(`select_variant_measured`, `measured_tune`), the Chrome-trace exporter,
the perf-baseline layer and the exposition lint, each against the
reference (`repro.obs`, `repro.core.tuner`) on the same inputs, on the CPU
(``backend="torch"``, ``device="cpu"``; the reference on ``"xla"``).

No test asserts a CPU wall-clock ratio: timing identities run under a
stubbed clock or a stubbed `measure`.  Floats computed from identical
samples by identical formulas are compared with ``pytest.approx`` at its
default tolerance (relative 1e-6); everything else must be equal."""
import dataclasses
import itertools
import json

import numpy as np
import pytest

import repro.core.advisor as j_advisor
import repro.core.model as j_model
import repro.core.tuner as j_tuner
import repro.graphs.csr as j_csr
import repro.obs as j_obs
import repro.obs.profile as j_profile
from repro.serving.plan_cache import PlanCache as JPlanCache
from repro.serving.plan_cache import shape_class_fingerprint as j_shape_fp

import repro_torch.obs as t_obs
import repro_torch.obs.profile as t_profile
from repro_torch.core import advisor as t_advisor
from repro_torch.core import tuner as t_tuner
from repro_torch.core.model import AggConfig
from repro_torch.graphs import csr as t_csr
from repro_torch.launch import serve_gnn, train
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.serving import PlanCache

# the reference's own fixtures (tests/test_profile.py) and a few more
SAMPLE_CASES = [
    (0.5, 0.1, 0.9, 0.3, 0.7, 0.2),
    (1.0,) * 9 + (100.0,),
    (3e-4,),
    (2e-3, 1e-3),
    (5.0, 4.0, 3.0, 2.0, 1.0),
]
# a pinned config both packages partition alike (the tuners' models differ)
PIN = dict(gs=8, gpt=8, ont=8, src_win=64, dt=16)


def _graph(seed=0, n=300, deg=5.0):
    return j_csr.random_power_law(n, deg, seed=seed)


def _plans(cfg_kw=PIN, with_backward=True, seed=0):
    g = _graph(seed)
    jp = j_advisor.plan_for(g, arch="gcn", in_dim=16, hidden_dim=16,
                            config=j_model.AggConfig(**cfg_kw),
                            with_backward=with_backward)
    tp = t_advisor.plan_for(g, arch="gcn", in_dim=16, hidden_dim=16,
                            config=AggConfig(**cfg_kw),
                            with_backward=with_backward)
    return jp, tp


# ---------------------------------------------------------- Measurement

@pytest.mark.parametrize("samples", SAMPLE_CASES)
def test_measurement_fields_match_reference(samples):
    j = j_profile.Measurement(samples=samples, warmup=2)
    t = t_profile.Measurement(samples=samples, warmup=2)
    for name in ("count", "warmup"):
        assert getattr(t, name) == getattr(j, name)
    for name in ("mean", "trimmed_mean", "p50", "p90", "min", "max",
                 "spread_rel"):
        assert getattr(t, name) == pytest.approx(getattr(j, name))
    assert t.to_row().keys() == j.to_row().keys()
    for k, v in j.to_row().items():
        assert t.to_row()[k] == pytest.approx(v)
    # the port's device-sample field is empty off the card
    assert t.device_samples == () and np.isnan(t.device_p50)


# durations each clock pair reads: a slow first call, jitter, a stable pair
DURATIONS = [
    [0.05, 0.01, 0.0101, 0.01, 0.011, 0.012, 0.01],
    [0.02, 0.01, 0.02, 0.01, 0.02, 0.01, 0.02, 0.01, 0.02, 0.003, 0.004,
     0.005],
    [0.001] * 10,
]


def _clock(durations):
    """perf_counter readings whose consecutive pairs differ by
    ``durations``."""
    readings, now = [], 100.0
    for d in durations:
        readings += [now, now + d]
        now += d + 1e-4
    return iter(readings).__next__


@pytest.mark.parametrize("durations", DURATIONS)
@pytest.mark.parametrize("warmup", [None, 0, 3])
def test_measure_warmup_rule_matches_reference(durations, warmup,
                                               monkeypatch):
    """The same sequence of `time.perf_counter` readings gives the same
    calibrated warm-up count and the same samples in both packages."""
    got = {}
    for name, mod in (("ref", j_profile), ("port", t_profile)):
        monkeypatch.setattr(mod.time, "perf_counter", _clock(durations))
        got[name] = mod.measure(lambda: None, warmup=warmup, iters=3,
                                max_warmup=6)
    assert got["port"].warmup == got["ref"].warmup
    assert got["port"].samples == pytest.approx(got["ref"].samples)
    assert got["port"].device_samples == ()


def test_measure_rejects_zero_iters():
    with pytest.raises(ValueError):
        t_profile.measure(lambda: None, iters=0)


# --------------------------------------------------------- profile_plan

def _fixed_measure(p50s):
    """A `measure` stand-in returning the given p50s (seconds) in call
    order, each as three samples around it."""
    it = iter(p50s)

    def fake(fn, *args, warmup=None, iters=5, **kw):
        p = next(it)
        return t_profile.Measurement(samples=(0.9 * p, p, 1.1 * p),
                                     warmup=warmup or 0)
    return fake


def test_profile_plan_schedules_match_reference():
    """Schedule names, tiles and edges of the reference's report on the
    same plan (the reference on "xla", the port on the plain versions)."""
    jp, tp = _plans()
    jrep = j_obs.profile_plan(jp, dim=16, iters=1, warmup=0, label="b16/")
    trep = t_obs.profile_plan(tp, dim=16, iters=1, warmup=0, label="b16/",
                              backend="torch", device="cpu")
    assert ([s.schedule for s in trep.schedules]
            == [s.schedule for s in jrep.schedules]
            == ["b16/forward", "b16/backward"])
    assert [s.tiles for s in trep.schedules] == [s.tiles for s in
                                                 jrep.schedules]
    assert [s.edges for s in trep.schedules] == [s.edges for s in
                                                 jrep.schedules]
    assert trep.dim == jrep.dim == 16 and trep.backend == "torch"
    assert set(trep.attribution()) == set(jrep.attribution())
    assert trep.to_rows()[0].keys() == jrep.to_rows()[0].keys()
    for s in trep.schedules:
        assert s.model_latency_s > 0 and s.model_bytes > 0
        assert s.measured.count == 1


def test_profile_plan_forward_only_plan():
    jp, tp = _plans(with_backward=False)
    trep = t_obs.profile_plan(tp, dim=8, iters=2, warmup=0, backend="torch",
                              device="cpu")
    assert [s.schedule for s in trep.schedules] == ["forward"]
    assert trep.schedules[0].tiles == jp.partition.num_tiles


@pytest.mark.parametrize("fwd,bwd,total", [(1e-3, 2e-3, 3.3e-3),
                                           (1e-3, 1e-3, 1e-3),
                                           (5e-4, 2.5e-4, 7.5e-4)])
def test_profile_plan_attribution_under_stubbed_measure(fwd, bwd, total,
                                                        monkeypatch):
    """The attribution identity, residual and achieved rates from stubbed
    timings, equal to the reference's `ProfileReport` on the same ones."""
    _, tp = _plans()
    monkeypatch.setattr(t_profile, "measure",
                        _fixed_measure([fwd, bwd, total]))
    reg = t_obs.MetricsRegistry()
    rep = t_obs.profile_plan(tp, dim=16, iters=3, backend="torch",
                             device="cpu", registry=reg)
    assert rep.attribution() == pytest.approx({"forward": fwd,
                                               "backward": bwd})
    assert rep.attribution_error() == pytest.approx(
        abs(fwd + bwd - total) / total)
    jrep = j_profile.ProfileReport(
        schedules=tuple(j_profile.ScheduleProfile(
            schedule=s.schedule, measured=j_profile.Measurement(
                samples=s.measured.samples, warmup=s.measured.warmup),
            model_latency_s=s.model_latency_s, model_bytes=s.model_bytes,
            edges=s.edges, tiles=s.tiles) for s in rep.schedules),
        total=j_profile.Measurement(samples=rep.total.samples, warmup=0),
        dim=rep.dim, backend=rep.backend)
    assert rep.attribution_error() == pytest.approx(jrep.attribution_error())
    for s, js in zip(rep.schedules, jrep.schedules):
        assert s.to_row() == pytest.approx(js.to_row())
        assert s.residual == pytest.approx(s.measured.p50
                                           / s.model_latency_s)
    # the histogram is fed the raw (stubbed) samples
    hist = {m["labels"]["schedule"]: m for m in reg.snapshot()
            if m["name"] == "profile_schedule_seconds"}
    assert {k: v["count"] for k, v in hist.items()} == {"forward": 3,
                                                        "backward": 3}
    assert hist["forward"]["sum"] == pytest.approx(3 * fwd)


def test_profile_plan_refuses_shards():
    """``shards=`` now profiles each sub-plan (see
    `tests/test_torch_graph_shard.py`); a count below one is refused by
    the splitter, as in the reference."""
    _, tp = _plans()
    with pytest.raises(ValueError, match="num_shards must be >= 1"):
        t_obs.profile_plan(tp, dim=8, shards=-1, backend="torch",
                           device="cpu")


def _metric_keys(reg):
    return sorted((m["name"], m["type"], tuple(sorted(m["labels"].items())))
                  for m in reg.snapshot())


def _stub_both(monkeypatch, p50s, cycle=False):
    """Stub `measure` in both packages with the same p50 sequence (each
    package reads its own copy; ``cycle`` repeats it)."""
    it = itertools.cycle if cycle else iter
    jit, tit = it(list(p50s)), it(list(p50s))
    monkeypatch.setattr(j_profile, "measure", lambda fn, *a, **k: (
        j_profile.Measurement(samples=(next(jit),), warmup=0)))
    monkeypatch.setattr(t_profile, "measure", lambda fn, *a, **k: (
        t_profile.Measurement(samples=(next(tit),), warmup=0)))


def test_registry_metrics_match_reference(monkeypatch):
    """The metric names, types and label sets `profile_plan` and
    `select_variant_measured` write are the reference's."""
    jp, tp = _plans(cfg_kw=dict(PIN, variant="direct"))
    times = [1e-3, 2e-3, 3e-3, 1e-3, 5e-4]
    _stub_both(monkeypatch, times)
    jreg, treg = j_obs.MetricsRegistry(), t_obs.MetricsRegistry()
    j_obs.profile_plan(jp, dim=16, registry=jreg, label="b16/")
    t_obs.profile_plan(tp, dim=16, registry=treg, label="b16/",
                       backend="torch", device="cpu")
    j_tuner.select_variant_measured(jp, backend="xla", registry=jreg)
    t_tuner.select_variant_measured(tp, backend="torch", device="cpu",
                                    registry=treg)
    assert _metric_keys(treg) == _metric_keys(jreg)
    jd = {m["name"]: m["desc"] for m in jreg.snapshot()}
    td = {m["name"]: m["desc"] for m in treg.snapshot()}
    assert td == jd
    # the '/' in label values survives the exposition format
    assert t_obs.lint_prometheus(t_obs.to_prometheus_text(treg)) == []


# ------------------------------------------------------ measured stage

# (candidates, their p50s in call order, margin)
RACES = [
    (("folded", "direct"), (1.0, 0.96), 0.05),
    (("folded", "direct"), (1.0, 0.95), 0.05),      # the margin's edge
    (("folded", "direct"), (1.0, 0.9499), 0.05),
    (("folded", "direct"), (1.0, 0.5), 0.05),
    (("folded", "direct"), (1.0, 1.5), 0.05),
    (("folded", "direct"), (1.0, 0.5), 1.0),
    (("folded", "slot_onehot", "direct"), (1.0, 0.9, 0.88), 0.05),
    (("folded", "slot_onehot", "direct"), (1.0, 0.9, 0.8), 0.05),
    (("direct", "folded"), (1.0, 0.94), 0.05),
]


@pytest.mark.parametrize("variants,p50s,margin", RACES)
def test_select_variant_measured_matches_reference(variants, p50s, margin,
                                                   monkeypatch):
    jp, tp = _plans(with_backward=False)
    _stub_both(monkeypatch, p50s)
    jreg, treg = j_obs.MetricsRegistry(), t_obs.MetricsRegistry()
    jbest, jt = j_tuner.select_variant_measured(
        jp, backend="xla", variants=variants, margin=margin, registry=jreg)
    tbest, tt = t_tuner.select_variant_measured(
        tp, backend="torch", device="cpu", variants=variants, margin=margin,
        registry=treg)
    assert tbest == jbest and tt == jt
    winners = {m["labels"]["variant"]: m["value"] for m in treg.snapshot()
               if m["name"] == "variant_selected_total"}
    assert winners == {tbest: 1}


def test_select_variant_measured_races_device_p50s_when_measured(
        monkeypatch):
    """With device-only samples (the card) the race compares their p50s,
    not the wall p50s that carry the host's jitter."""
    _, tp = _plans(with_backward=False)
    walls, devs = iter([1e-4, 0.5e-4]), iter([2e-5, 3e-5])
    monkeypatch.setattr(t_profile, "measure", lambda fn, *a, **k: (
        t_profile.Measurement(samples=(next(walls),), warmup=0,
                              device_samples=(next(devs),))))
    best, p50s = t_tuner.select_variant_measured(tp, backend="torch",
                                                 device="cpu")
    assert best == "folded" and p50s == {"folded": 2e-5, "direct": 3e-5}


def test_select_variant_measured_runs_the_plain_versions():
    """Unstubbed on the CPU: each candidate's executor runs (the plain
    version), the p50s are real, and a giant margin keeps the first."""
    _, tp = _plans(with_backward=False)
    best, p50s = t_tuner.select_variant_measured(
        tp, backend="torch", device="cpu", iters=2, warmup=1, margin=1.0)
    assert best == "folded" and set(p50s) == {"folded", "direct"}
    assert all(p > 0 for p in p50s.values())
    with pytest.raises(ValueError):
        t_tuner.select_variant_measured(tp, backend="torch", device="cpu",
                                        variants=())


def test_plan_facing_dim_matches_reference():
    g = _graph()
    for arch, ind, hid in (("gcn", 32, 8), ("gin", 32, 8), ("gat", 12, 20)):
        jp = j_advisor.plan_for(g, arch=arch, in_dim=ind, hidden_dim=hid,
                                config=j_model.AggConfig(**PIN))
        tp = t_advisor.plan_for(g, arch=arch, in_dim=ind, hidden_dim=hid,
                                config=AggConfig(**PIN))
        assert t_tuner.plan_facing_dim(tp) == j_tuner.plan_facing_dim(jp)
    assert t_tuner.plan_facing_dim(object(), default=7) == 7


def test_measured_tune_best_is_the_table_argmin(monkeypatch):
    """``best`` is the measured table's argmin with its variant stamped in;
    the table holds top_k configs x every variant."""
    g = t_csr.random_power_law(200, 5.0, seed=21)
    p50 = {}

    def fake(fn, *args, **kw):
        s = fn.sched
        key = (s.gs, s.gpt, s.src_win, fn.dt, fn.variant)
        p50[key] = 1e-3 * (1 + (7 * s.gs + 3 * s.gpt + s.src_win + fn.dt)
                           % 13 / 13 + 0.5 * (fn.variant == "direct"))
        return t_profile.Measurement(samples=(p50[key],), warmup=0)

    monkeypatch.setattr(t_profile, "measure", fake)
    res = t_tuner.measured_tune(g, 16, top_k=2, iters=3, pop=6,
                                backend="torch", device="cpu")
    assert len(res.measured) == 2 * len(t_tuner.MEASURED_VARIANTS)
    (cfg, v), best = min(res.measured.items(), key=lambda kv: kv[1])
    assert res.best == dataclasses.replace(cfg, variant=v)
    assert res.best_score == best
    assert [c for _, c in res.top[:2]] == list(dict.fromkeys(
        c for c, _ in res.measured))


def test_measured_tune_unstubbed_table():
    g = t_csr.random_power_law(200, 5.0, seed=21)
    res = t_tuner.measured_tune(g, 16, top_k=2, iters=3, pop=6,
                                measure_iters=2, warmup=1,
                                backend="torch", device="cpu")
    assert res.best.variant in t_tuner.MEASURED_VARIANTS
    assert res.best_score == min(res.measured.values()) > 0


# ------------------------------------------------------------ PlanCache

def _request_graphs():
    """Ego-batch-like graphs with repeats: same structure (exact hit),
    same shape class with other edge values (config + variant memo hit),
    and new shape classes."""
    gs = [j_csr.random_power_law(n, d, seed=s)
          for n, d, s in ((120, 4.0, 1), (120, 4.0, 2), (260, 6.0, 3),
                          (120, 4.0, 1), (500, 3.0, 4), (260, 6.0, 5))]
    rng = np.random.default_rng(0)
    vals = [None, None, None,
            rng.uniform(0.5, 1.5, gs[3].num_edges).astype(np.float32),
            None, None]
    return list(zip(gs, vals))


@pytest.mark.parametrize("dims", [(16, 16), (16, 100)])
def test_plan_cache_measured_variants_match_reference(dims, monkeypatch):
    """One request sequence through both caches (the reference keyed on
    the shape-class fingerprint, as its serving engine is): the same
    exact / config / variant-memo accounting, and `invalidate` drops the
    same number of entries at every level."""
    in_dim, hid = dims
    _stub_both(monkeypatch, [1e-3, 5e-4], cycle=True)
    jc = JPlanCache(backend="xla", tune_iters=2, measure_variants=True,
                    fingerprint_fn=j_shape_fp)
    tc = PlanCache(backend="torch", device="cpu", tune_iters=2,
                   measure_variants=True)
    seq = _request_graphs()
    for epoch, (g, ev) in enumerate(seq):
        ep = epoch // 3
        je = jc.get_or_build(g, arch="gcn", in_dim=in_dim, hidden_dim=hid,
                             num_layers=2, edge_vals=ev, epoch=ep)
        te = tc.get_or_build(g, arch="gcn", in_dim=in_dim, hidden_dim=hid,
                             num_layers=2, edge_vals=ev, epoch=ep)
        assert te.plan.config.variant == je.plan.config.variant == "direct"
    js, ts = jc.stats(), tc.stats()
    for k in ("lookups", "exact_hits", "config_hits", "misses", "plans",
              "configs", "variant_selections", "variant_memo_hits"):
        assert ts[k] == js[k], k
    assert ts["variant_selections"] >= 1 and ts["variant_memo_hits"] >= 1
    # the same three selectors, in the same order, drop the same counts
    fp_j = next(iter(jc._plans.values())).fingerprint
    fp_t = next(iter(tc._plans.values())).fingerprint
    assert tc.invalidate(fp_t) == jc.invalidate(fp_j)
    assert tc.invalidate(before_epoch=1) == jc.invalidate(before_epoch=1)
    assert len(tc._variants) == len(jc._variants) == 0
    assert tc.invalidate() == jc.invalidate()
    assert tc.stats()["invalidations"] == jc.stats()["invalidations"]


def test_plan_cache_variant_memo_bounded_by_max_configs(monkeypatch):
    _stub_both(monkeypatch, [1e-3, 2e-3], cycle=True)
    tc = PlanCache(backend="torch", device="cpu", tune_iters=2,
                   measure_variants=True, max_configs=2,
                   variant_candidates=("folded", "direct"))
    for g, _ in _request_graphs():
        tc.get_or_build(g, arch="gcn", in_dim=16, hidden_dim=16,
                        num_layers=2)
    assert len(tc._variants) <= 2
    # folded (first candidate) wins every stubbed race: the pin stays
    assert all(e.plan.config.variant == "folded"
               for e in tc._plans.values())


def test_plan_cache_measurement_overrides_the_variant_pin(monkeypatch):
    _stub_both(monkeypatch, [1e-3, 1e-4], cycle=True)
    g = j_csr.random_power_law(150, 5.0, seed=9)
    pinned = PlanCache(backend="torch", device="cpu", tune_iters=2,
                       variant="slot_onehot")
    measured = PlanCache(backend="torch", device="cpu", tune_iters=2,
                         variant="slot_onehot", measure_variants=True)
    kw = dict(arch="gcn", in_dim=16, hidden_dim=16, num_layers=2)
    assert pinned.get_or_build(g, **kw).plan.config.variant == "slot_onehot"
    ent = measured.get_or_build(g, **kw)
    assert ent.plan.config.variant == "direct"
    assert ent.executor.variant == "direct"
    assert measured.stats()["variant_selections"] == 1


# ---------------------------------------------------------- chrome trace

RECORDS = [
    {"span": "train", "t_rel_s": 0.0, "duration_s": 0.5, "tid": 0,
     "thread": "MainThread", "attrs": {"steps": 2}},
    {"span": "train/step", "t_rel_s": 0.1, "duration_s": 0.2, "tid": 0,
     "thread": "MainThread", "attrs": {"step": 0}},
    {"span": "serve_batch/compute", "t_rel_s": 0.05, "duration_s": 0.01,
     "tid": 1, "thread": "serve-worker"},
    {"span": "bare", "t_rel_s": 0.3, "duration_s": 0.0},
]


def _without_process_name(doc):
    doc = json.loads(json.dumps(doc))
    for e in doc["traceEvents"]:
        if e["name"] == "process_name":
            e["args"]["name"] = "*"
    return doc


@pytest.mark.parametrize("context", [None, {"git_sha": "abc", "device": "x"}])
def test_chrome_trace_doc_matches_reference(context):
    j = j_obs.chrome_trace_doc(records=RECORDS, context=context)
    t = t_obs.chrome_trace_doc(records=RECORDS, context=context)
    assert _without_process_name(t) == _without_process_name(j)
    assert [e["args"]["name"] for e in t["traceEvents"]
            if e["name"] == "process_name"] == ["repro_torch"]
    with pytest.raises(ValueError):
        t_obs.chrome_trace_doc()


def test_chrome_trace_from_tracer_and_file_round_trip(tmp_path):
    reg = t_obs.MetricsRegistry()
    tr = t_obs.SpanTracer(reg)
    with tr.span("outer", k=1):
        with tr.span("inner"):
            pass
    j = j_obs.chrome_trace_doc(records=tr.records())
    t = t_obs.chrome_trace_doc(tr)
    assert _without_process_name(t) == _without_process_name(j)
    path = tmp_path / "trace.json"
    t_obs.write_chrome_trace(str(path), tr, context={"git_sha": "abc"})
    doc = json.load(open(path))
    assert doc == t_obs.chrome_trace_doc(tr, context={"git_sha": "abc"})
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert names == {"outer", "outer/inner"}


# ------------------------------------------------------------- baseline

def _rows(us, spread=0.05):
    return [{"name": "agg/x/group", "us_per_call": us,
             "p50_us": us, "p90_us": us * (1 + spread)}]


def _mutated(mutate):
    def doc(mod):
        d = mod.make_baseline("bench_x", _rows(100.0),
                              context={"git_sha": "abc"})
        mutate(d)
        return d
    return doc


@pytest.mark.parametrize("mutate", [
    lambda d: None,
    lambda d: d.update(schema="nope"),
    lambda d: d.update(rows=[]),
    lambda d: d["rows"][0].pop("us_per_call"),
    lambda d: d["rows"][0].pop("name"),
    lambda d: d.update(history="not-a-list"),
    lambda d: d.update(context={"git_sha": ""}),
])
def test_validate_baseline_matches_reference(mutate):
    make = _mutated(mutate)
    assert (t_obs.validate_baseline(make(t_obs), "f.json")
            == j_obs.validate_baseline(make(j_obs), "f.json"))
    assert t_obs.validate_baseline("x") == j_obs.validate_baseline("x")
    assert t_obs.BASELINE_SCHEMA == j_obs.BASELINE_SCHEMA


@pytest.mark.parametrize("base,cur,kw", [
    ({"us_per_call": 10.0}, None, {}),
    (_rows(100.0, 0.05)[0], None, {}),
    (_rows(100.0, 0.01)[0], None, {"rel_floor": 0.10}),
    (_rows(100.0, 0.05)[0], _rows(100.0, 0.20)[0], {}),
    (_rows(100.0, 0.05)[0], _rows(90.0, 0.02)[0], {"noise_factor": 5.0}),
])
def test_row_tolerance_matches_reference(base, cur, kw):
    assert t_obs.row_tolerance(base, cur, **kw) == j_obs.row_tolerance(
        base, cur, **kw)


@pytest.mark.parametrize("base,cur", [
    (_rows(100.0) + [{"name": "gone", "us_per_call": 5.0}],
     _rows(100.0) + [{"name": "fresh", "us_per_call": 1.0}]),
    (_rows(100.0), _rows(200.0)),
    (_rows(100.0), _rows(50.0)),
    (_rows(100.0, 0.20), _rows(140.0, 0.20)),
    (_rows(100.0), _rows(140.0)),
    ([{"name": "zero", "us_per_call": 0.0}],
     [{"name": "zero", "us_per_call": 3.0}]),
])
def test_compare_rows_matches_reference(base, cur):
    assert t_obs.compare_rows(base, cur) == j_obs.compare_rows(base, cur)


def test_append_history_and_file_round_trip_match_reference(tmp_path):
    docs = {}
    for name, mod in (("ref", j_obs), ("port", t_obs)):
        doc = mod.make_baseline("s", _rows(1.0))
        for i in range(60):
            mod.append_history(doc, _rows(float(i + 1)),
                               context={"git_sha": f"sha{i}",
                                        "timestamp": str(i)},
                               max_history=50)
        path = str(tmp_path / f"{name}.json")
        mod.save_baseline(doc, path)
        docs[name] = mod.load_baseline(path)
    assert docs["port"] == docs["ref"]
    assert len(docs["port"]["history"]) == 50


# ------------------------------------------------------ exposition lint

PROM_CASES = [
    '# TYPE a counter\na{x="b/c"} 1\n',
    '# TYPE a counter\na{x="b"c"} 1\n',
    'a 1\n',
    '# TYPE h histogram\nh_bucket{le="1"} 2\nh_bucket{le="+Inf"} 1\n'
    'h_count 1\n',
    '# TYPE h histogram\nh_bucket{le="1"} 1\nh_count 1\n',
    '# TYPE g gauge\ng{a="1",b="2"} NaN\n',
    'not a sample line\n',
]


@pytest.mark.parametrize("text", PROM_CASES)
def test_lint_prometheus_matches_reference(text):
    assert t_obs.lint_prometheus(text) == j_obs.lint_prometheus(text)


@pytest.mark.parametrize("value", ['b16/forward', 'a"b', 'x\\y', 'l1\nl2',
                                   ''])
def test_unescape_label_value_matches_reference(value):
    from repro.obs.export import _escape_label_value as j_esc

    from repro_torch.obs.export import _escape_label_value as t_esc
    assert t_esc(value) == j_esc(value)
    assert (t_obs.unescape_label_value(t_esc(value))
            == j_obs.unescape_label_value(j_esc(value)) == value)


def test_lint_matches_le_as_a_whole_label_name():
    """Two histogram series told apart by a label whose name ends in "le"
    (``schedule``, which every profiling histogram carries): the port's
    lint keeps them apart and passes them; the reference's pattern merges
    them and reports them as not cumulative (the one repaired
    difference), while a real non-cumulative ``le`` series still fails."""
    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.histogram("h_seconds", labels={"schedule": "b16/forward"}
                      ).observe(1e-5)
        back = reg.histogram("h_seconds",
                             labels={"schedule": "b16/backward"})
        for _ in range(5):
            back.observe(0.5)
        return mod.to_prometheus_text(reg)
    assert t_obs.lint_prometheus(fill(t_obs)) == []
    assert fill(t_obs) == fill(j_obs)
    assert any("not cumulative" in p
               for p in j_obs.lint_prometheus(fill(j_obs)))
    bad = ('# TYPE h histogram\nh_bucket{schedule="a",le="1"} 2\n'
           'h_bucket{schedule="a",le="+Inf"} 1\nh_count{schedule="a"} 1\n')
    assert any("not cumulative" in p for p in t_obs.lint_prometheus(bad))


def test_profiling_registry_lints_clean():
    """A registry filled by `profile_plan` and `select_variant_measured`
    (labels with '/' in their values) renders to clean exposition text."""
    _, tp = _plans()
    reg = t_obs.MetricsRegistry()
    t_obs.profile_plan(tp, dim=16, iters=2, warmup=1, registry=reg,
                       label="b16/", backend="torch", device="cpu")
    t_tuner.select_variant_measured(tp, backend="torch", device="cpu",
                                    iters=2, warmup=1, registry=reg)
    text = t_obs.to_prometheus_text(reg)
    assert 'schedule="b16/forward"' in text
    assert t_obs.lint_prometheus(text) == []


# ------------------------------------------------------------ drivers

def _trace_doc(path):
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    threads = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
               if e["name"] == "thread_name"}
    assert {e["tid"] for e in spans} <= set(threads)
    assert doc["otherData"]["git_sha"]
    return names, threads


def test_driver_accepts_trace_out():
    """``--trace-out`` is a flag of both drivers now (it was refused while
    the exporter was not ported)."""
    assert serve_gnn.parse_args(["--smoke", "--trace-out",
                                 "t.json"]).trace_out == "t.json"
    assert train.parse_args(["--arch", "gcn", "--trace-out",
                             "t.json"]).trace_out == "t.json"


@pytest.mark.parametrize("flags,threads", [
    ([], 1),
    (["--policy", "deadline", "--tenants", "3"], 2),
])
def test_serve_gnn_writes_chrome_trace(flags, threads, tmp_path):
    path = str(tmp_path / "serve.json")
    res = serve_gnn.run(["--smoke", "--device", "cpu", "--backend", "torch",
                         "--trace-out", path] + flags)
    assert res["ok"]
    names, tids = _trace_doc(path)
    assert {"serve_batch", "serve_batch/compute"} <= names
    assert len(tids) >= threads
    if threads > 1:
        assert "serve-worker" in tids.values()


@pytest.mark.parametrize("flags", [
    ["--dataset", "cora", "--steps", "3", "--ckpt-every", "2"],
    ["--sampled", "--dataset", "cora", "--steps", "2", "--max-nodes", "600",
     "--batch-nodes", "64", "--fanouts", "4,3"],
])
def test_train_writes_chrome_trace(flags, tmp_path):
    path = str(tmp_path / "train.json")
    res = train.run(["--arch", "gcn", "--device", "cpu", "--backend",
                     "torch", "--hidden-dim", "8", "--ckpt-dir",
                     str(tmp_path / "ck"), "--trace-out", path] + flags)
    assert res["ok"]
    names, _ = _trace_doc(path)
    assert {"train", "train/step", "train/step/batch"} <= names


def test_trainer_emits_nested_train_spans(tmp_path):
    """As the reference's test of the same name: the port's Trainer under
    a tracer, and the structure survives the Chrome-trace export."""
    reg = t_obs.MetricsRegistry()
    tr = t_obs.SpanTracer(reg)
    trainer = Trainer(
        TrainerConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                      log_every=100),
        lambda state, batch: (state + 1, {"loss": float(state)}),
        lambda step: step, 0, tracer=tr)
    trainer.run(4)
    trainer.close()
    paths = {r["span"] for r in tr.records()}
    assert {"train", "train/step", "train/step/batch",
            "train/checkpoint"} <= paths
    doc = t_obs.chrome_trace_doc(tr)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert any(n.startswith("train/") for n in names)


def test_serve_gnn_through_a_measuring_cache():
    """`serve_gnn.run(cache=...)` serves through a shared
    `PlanCache(measure_variants=True)`: races happen, their decisions are
    reused, and the run's verify holds."""
    cache = PlanCache(backend="torch", device="cpu", tune_iters=2,
                      measure_variants=True)
    res = serve_gnn.run(["--smoke", "--device", "cpu", "--backend",
                         "torch", "--verify", "2"], cache=cache)
    st = cache.stats()
    assert res["ok"] and res["engine"].cache is cache
    assert st["variant_selections"] >= 1
    # every built plan is raced or takes a memoized decision
    assert (st["variant_selections"] + st["variant_memo_hits"]
            == st["misses"] + st["config_hits"])
