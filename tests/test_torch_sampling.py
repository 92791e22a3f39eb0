"""Port sampled-training parity: the fanout sampler, the prefetching
loader, the train-ready plan cache, the block forward / loss, the eager
train step and ``train --sampled``, against `repro.sampling` on the same
graph, seeds and weights (made with numpy from a seed; weights and
optimizer state carried across with `params_from_jax` /
`opt_state_from_jax`).

The port runs on the CPU with its plain PyTorch versions (``device="cpu"``,
``backend="torch"``); the reference on ``backend="xla"`` and, once, on
``"pallas_interpret"`` as its own tests run it.  Tolerances, stated per
test:
  * sampled blocks and planned batches: bit-equal (the sampler and the
    planner are the same numpy code; bf16 features are both rounded to
    nearest even);
  * block logits and losses: ``max|a-b| / (1 + |b|)`` <= 1e-5 (float32)
    and 2e-2 (bfloat16);
  * three train steps: ``max|a-b| / (1 + |b|)`` <= 1e-5 on losses and
    parameters (the limit of `test_train_steps_match_reference`).
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
import repro.models.gnn as j_gnn
import repro.optim.adamw as j_adamw
import repro.sampling.loader as j_loader
import repro.sampling.neighbor as j_neighbor
from repro.core.aggregate import PlanExecutor as JPlanExecutor

import repro_torch.graphs.csr as t_csr
from repro_torch.launch import train as t_train
from repro_torch.models import gnn as t_gnn
from repro_torch.optim import adamw as t_adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sampling import loader as t_loader
from repro_torch.sampling import neighbor as t_neighbor
from repro_torch.serving.plan_cache import PlanCache, bucket_pow2

PART_ARRAYS = ("nbrs", "edge_val", "local_node", "tile_node_block",
               "tile_window", "edge_slot", "edge_pos")
PART_STATICS = ("gs", "gpt", "ont", "src_win", "num_nodes", "num_edges",
                "num_tiles")
CPU = ["--device", "cpu", "--backend", "torch"]


def _normalized_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


@pytest.fixture(scope="module")
def graphs():
    jg = j_csr.random_power_law(400, 8.0, seed=0)
    return jg, t_csr.CSRGraph(jg.indptr, jg.indices)


def _data(g, in_dim, classes, seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((g.num_nodes, in_dim)).astype(np.float32)
    return feat, t_gnn.structural_labels(g, classes)


def _cfgs(arch, dtype="float32", in_dim=8, hidden=8, classes=3, layers=2):
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=in_dim, hidden_dim=hidden,
                           num_classes=classes, num_layers=layers,
                           backend="xla", feat_dtype=dtype)
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=in_dim, hidden_dim=hidden,
                           num_classes=classes, num_layers=layers,
                           backend="torch", feat_dtype=dtype, device="cpu")
    return jcfg, tcfg


def _loaders(graphs, arch, dtype="float32", fanouts=(4, 2), batch_nodes=64,
             in_dim=8, **kw):
    """The reference's and the port's loader over the same graph, features
    and labels, no prefetch thread, train-ready plans."""
    jg, tg = graphs
    jcfg, tcfg = _cfgs(arch, dtype, in_dim=in_dim, **kw)
    feat, labels = _data(tg, in_dim, jcfg.num_classes)
    jl = j_loader.SampledLoader(
        jg, feat, labels, jcfg,
        j_loader.LoaderConfig(fanouts=fanouts, batch_nodes=batch_nodes,
                              seed=0),
        start_thread=False, with_backward=True)
    tl = t_loader.SampledLoader(
        tg, feat, labels, tcfg,
        t_loader.LoaderConfig(fanouts=fanouts, batch_nodes=batch_nodes,
                              seed=0),
        start_thread=False, with_backward=True)
    return jcfg, tcfg, jl, tl


def _assert_partition_equal(tp, jp, what):
    for f in PART_ARRAYS:
        np.testing.assert_array_equal(getattr(tp, f), np.asarray(
            getattr(jp, f)), err_msg=f"{what}.{f}")
    for f in PART_STATICS:
        assert getattr(tp, f) == getattr(jp, f), (what, f)


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("edge_mode", ["gcn", "scale", "unit"])
def test_sample_blocks_bit_equal(graphs, edge_mode):
    jg, tg = graphs
    seeds = np.random.default_rng(3).choice(tg.num_nodes, 37, replace=False)
    for seed, fanouts in ((0, (4, 2)), (5, (10, 5, 3))):
        jb = j_neighbor.sample_blocks(jg, seeds, fanouts, seed=seed,
                                      edge_mode=edge_mode)
        tb = t_neighbor.sample_blocks(tg, seeds, fanouts, seed=seed,
                                      edge_mode=edge_mode)
        np.testing.assert_array_equal(tb.seeds, jb.seeds)
        np.testing.assert_array_equal(tb.input_nodes, jb.input_nodes)
        assert tb.num_layers == jb.num_layers == len(fanouts)
        for t, j in zip(tb.blocks, jb.blocks):
            assert t.num_dst == j.num_dst and t.num_src == j.num_src
            np.testing.assert_array_equal(t.src_nodes, j.src_nodes)
            np.testing.assert_array_equal(t.graph.indptr, j.graph.indptr)
            np.testing.assert_array_equal(t.graph.indices, j.graph.indices)
            assert t.edge_vals.dtype == j.edge_vals.dtype == np.float32
            np.testing.assert_array_equal(t.edge_vals, j.edge_vals)
            feat = np.random.default_rng(1).standard_normal(
                (t.num_src, 3)).astype(np.float32)
            np.testing.assert_array_equal(
                t_neighbor.block_aggregate_ref(t, feat),
                j_neighbor.block_aggregate_ref(j, feat))


@pytest.mark.parametrize("seeds,fanouts,kw,match", [
    ([], [3], {}, "seed"),
    ([400], [3], {}, "out of range"),
    ([0], [], {}, "fanout"),
    ([0], [2], {"edge_mode": "nope"}, "edge_mode"),
])
def test_sampler_rejects_bad_inputs(graphs, seeds, fanouts, kw, match):
    with pytest.raises(ValueError, match=match):
        t_neighbor.sample_blocks(graphs[1], seeds, fanouts, **kw)


# ------------------------------------------------------ loader vs reference

@pytest.mark.parametrize("arch,dtype", [("gcn", "float32"),
                                        ("gcn", "bfloat16"),
                                        ("gin", "float32")])
def test_batches_bit_equal(graphs, arch, dtype):
    """Seeds, raw sizes, each layer's AggConfig, the forward and backward
    partitions and the padded feat / labels / mask of a few steps."""
    _, _, jl, tl = _loaders(graphs, arch, dtype)
    assert tl.steps_per_epoch == jl.steps_per_epoch
    for step in (0, 1, 5, 7):
        jb, tb = jl.batch_for(step), tl.batch_for(step)
        np.testing.assert_array_equal(tb.seeds, jb.seeds)
        assert tb.num_seeds == jb.num_seeds and tb.step == step
        assert tb.raw_nodes == jb.raw_nodes and tb.raw_edges == jb.raw_edges
        assert len(tb.entries) == len(jb.entries) == 2
        for layer, (te, je) in enumerate(zip(tb.entries, jb.entries)):
            tp, jp = te.plan, je.plan
            assert (dataclasses.asdict(tp.config)
                    == dataclasses.asdict(jp.config)), layer
            assert tp.config.feat_dtype == dtype
            _assert_partition_equal(tp.partition, jp.partition, f"fwd{layer}")
            _assert_partition_equal(tp.partition_bwd, jp.partition_bwd,
                                    f"bwd{layer}")
            np.testing.assert_array_equal(tp.edge_perm_bwd, jp.edge_perm_bwd)
            for part in (tp.partition, tp.partition_bwd):
                assert part.num_tiles == bucket_pow2(part.num_tiles)
        assert tb.feat.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(tb.feat.float().numpy(),
                                      np.asarray(jb.feat, np.float32))
        np.testing.assert_array_equal(tb.labels.numpy(), jb.labels)
        np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)
        # the port's key is the reference's, with the port's backend name
        assert tb.key[2:] == jb.key[2:] and tb.key[1] == "torch"


def test_sampled_agg_config_matches_reference(graphs):
    for n in (16, 300, 5000, 70000):
        g = t_csr.CSRGraph(np.zeros(n + 1, np.int64), np.zeros(0, np.int32))
        t, j = (t_loader.sampled_agg_config(g),
                j_loader.sampled_agg_config(g))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ------------------------------------------------ block forward and loss

@pytest.mark.parametrize("arch,dtype,tol", [("gcn", "float32", 1e-5),
                                            ("gin", "float32", 1e-5),
                                            ("gcn", "bfloat16", 2e-2),
                                            ("gin", "bfloat16", 2e-2)])
def test_block_logits_and_loss_match_reference(graphs, arch, dtype, tol):
    jcfg, tcfg, jl, tl = _loaders(graphs, arch, dtype, hidden=12,
                                  classes=5)
    jb, tb = jl.batch_for(2), tl.batch_for(2)
    jparams = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(4))
    tparams = t_gnn.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jex = [e.executor for e in jb.entries]
    tex = [e.executor for e in tb.entries]
    jfeat = jnp.asarray(jb.feat)
    want = np.asarray(j_gnn.gnn_block_logits(jcfg, jparams, jfeat, jex))
    got = t_gnn.gnn_block_logits(tcfg, tparams, tb.feat, tex)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (tex[-1].sched.num_nodes, 5)
    assert _normalized_err(got.numpy(), want) <= tol
    jloss, jm = j_gnn.gnn_block_loss(jcfg, jparams, jfeat,
                                     jnp.asarray(jb.labels),
                                     jnp.asarray(jb.mask), jex)
    tloss, tm = t_gnn.gnn_block_loss(tcfg, tparams, tb.feat, tb.labels,
                                     tb.mask, tex)
    assert _normalized_err(float(tloss), float(jloss)) <= tol
    assert set(tm) == set(jm) == {"loss", "accuracy"}


@pytest.mark.parametrize("arch", ["gcn", "gin"])
def test_block_logits_match_reference_pallas_interpret(graphs, arch):
    """The reference's Pallas kernel in interpret mode, forward only, as
    its own sampled test runs it (fanouts 3, 2, batch 24)."""
    jcfg, tcfg, jl, tl = _loaders(graphs, arch, fanouts=(3, 2),
                                  batch_nodes=24)
    jb, tb = jl.batch_for(0), tl.batch_for(0)
    jparams = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(1))
    tparams = t_gnn.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jex = [JPlanExecutor(e.plan, backend="pallas_interpret")
           for e in jb.entries]
    pcfg = dataclasses.replace(jcfg, backend="pallas_interpret")
    want = np.asarray(j_gnn.gnn_block_logits(pcfg, jparams,
                                             jnp.asarray(jb.feat), jex))
    got = t_gnn.gnn_block_logits(tcfg, tparams, tb.feat,
                                 [e.executor for e in tb.entries])
    assert _normalized_err(got.numpy(), want) <= 1e-5


def test_block_logits_refuse_gat():
    cfg = t_gnn.GNNConfig(arch="gat", device="cpu", backend="torch")
    with pytest.raises(NotImplementedError, match="gcn/gin"):
        t_gnn.gnn_block_logits(cfg, {}, torch.zeros(1, 1), [])
    with pytest.raises(ValueError, match="gcn/gin"):
        t_loader.SampledTrainStep(cfg, t_adamw.AdamWConfig())


# ----------------------------------------------------------- train steps

@pytest.mark.parametrize("arch", ["gcn", "gin"])
def test_train_steps_match_reference(graphs, arch):
    jcfg, tcfg, jl, tl = _loaders(graphs, arch, hidden=12, classes=4)
    jopt = j_adamw.AdamWConfig(lr=1e-2,
                               schedule=j_adamw.cosine_schedule(1, 3))
    topt = t_adamw.AdamWConfig(lr=1e-2,
                               schedule=t_adamw.cosine_schedule(1, 3))
    jparams = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(5))
    jstate = (jparams, j_adamw.adamw_init(jparams))
    tparams = t_gnn.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    tstate = (tparams, t_adamw.opt_state_from_jax(jstate[1], "cpu"))
    jstep = j_loader.SampledTrainStep(jcfg, jopt)
    tstep = t_loader.SampledTrainStep(tcfg, topt)
    for s in range(3):
        jstate, jmet = jstep(jstate, jl.batch_for(s))
        tstate, tmet = tstep(tstate, tl.batch_for(s))
        assert _normalized_err(float(tmet["loss"]), float(jmet["loss"])) \
            <= 1e-5
        assert set(tmet) == {"loss", "accuracy", "grad_norm", "lr"}
    for k in jstate[0]:
        assert _normalized_err(tstate[0][k].numpy(), jstate[0][k]) <= 1e-5, k
    assert int(tstate[1].step) == 3
    assert tstep.num_buckets == jstep.num_buckets


# --------------------------------------------------- port-only behaviour

def _port_loader(graphs, batch_nodes, **kw):
    _, tg = graphs
    _, tcfg = _cfgs("gcn", in_dim=4, hidden=4)
    feat, labels = _data(tg, 4, 3)
    return t_loader.SampledLoader(
        tg, feat, labels, tcfg,
        t_loader.LoaderConfig(fanouts=(4, 2), batch_nodes=batch_nodes,
                              seed=0), **kw)


def test_loader_deterministic_and_epoch_coverage(graphs):
    loader = _port_loader(graphs, 100, start_thread=False)
    assert loader.steps_per_epoch == 4
    a, b = loader.batch_for(2), loader.batch_for(2)
    np.testing.assert_array_equal(a.seeds, b.seeds)
    assert torch.equal(a.feat, b.feat)
    seen = np.concatenate([loader.seeds_for(s) for s in range(4)])
    assert len(np.unique(seen)) == len(seen) == 400


def test_prefetch_matches_batch_for_and_restart_resyncs(graphs):
    with _port_loader(graphs, 64) as loader:
        want = [loader.batch_for(s) for s in range(3)]
        got = [loader(s) for s in range(3)]
        for w, g_ in zip(want, got):
            np.testing.assert_array_equal(w.seeds, g_.seeds)
            assert torch.equal(w.feat, g_.feat) and w.key == g_.key
        before = loader.stats()["resyncs"]
        # restart: jump back to step 0
        np.testing.assert_array_equal(loader(0).seeds, want[0].seeds)
        np.testing.assert_array_equal(loader(1).seeds, want[1].seeds)
        st = loader.stats()
        assert st["resyncs"] == before + 1
        assert st["batches_built"] >= 8
    assert loader._thread is None


def test_prefetch_out_of_order_under_thread_switching(graphs):
    """Restarts and skips with the interpreter switching threads every few
    microseconds: every request gets its own step's batch, the buffer
    never holds more than ``PREFETCH`` batches, and close() ends the
    worker."""
    import sys
    order = [0, 1, 2, 0, 1, 5, 6, 7, 3, 4, 4, 9, 10, 2, 3]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _port_loader(graphs, 32) as loader:
            want = {s: np.sort(loader.seeds_for(s)) for s in set(order)}
            for step in order:
                b = loader(step)
                assert b.step == step
                np.testing.assert_array_equal(b.seeds, want[step])
                assert len(loader._buf) <= t_loader.PREFETCH
            thread = loader._thread
        thread.join(timeout=10.0)
        assert not thread.is_alive()
    finally:
        sys.setswitchinterval(old)


def test_worker_error_reaches_consumer(graphs):
    """An exception in the prefetch worker is raised to the consumer (its
    cause attached), and nothing is buffered."""
    loader = _port_loader(graphs, 64, start_thread=False)

    def boom(step):
        raise RuntimeError("planner broke")

    loader.batch_for = boom
    loader._thread = threading.Thread(target=loader._worker, daemon=True)
    loader._thread.start()
    with pytest.raises(RuntimeError, match="worker died") as e:
        loader(0)
    assert "planner broke" in str(e.value.__cause__)
    assert not loader._buf
    loader.close()


def test_trainer_drives_loader_and_close_joins_worker(graphs, tmp_path):
    loader = _port_loader(graphs, 128)
    _, tcfg = _cfgs("gcn", in_dim=4, hidden=4)
    step = t_loader.SampledTrainStep(tcfg, t_adamw.AdamWConfig(lr=1e-2))
    params = t_gnn.init_gnn_params(tcfg)
    trainer = Trainer(
        TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100, log_every=100),
        step, loader, (params, t_adamw.adamw_init(params)),
        log_fn=lambda s: None)
    trainer.run(4)
    assert loader._thread is not None
    trainer.close()
    assert loader._thread is None                  # close() joined the worker
    assert len(trainer.metrics_history) == 4
    assert all(np.isfinite(m["loss"]) for m in trainer.metrics_history)


def test_zero_degree_seeds_train(graphs):
    """Isolated seeds still give a self-loop-only block and a finite
    loss through the loader and the step."""
    _, tg = graphs
    indptr = np.concatenate([tg.indptr, [tg.indptr[-1], tg.indptr[-1]]])
    g2 = t_csr.CSRGraph(indptr, tg.indices)
    seeds = np.array([g2.num_nodes - 1, g2.num_nodes - 2, 0])
    sb = t_neighbor.sample_blocks(g2, seeds, [3, 2], seed=0)
    blk = sb.blocks[1]
    assert (np.diff(blk.graph.indptr)[:blk.num_dst] >= 1).all()
    _, tcfg = _cfgs("gcn", in_dim=4, hidden=4)
    feat, labels = _data(g2, 4, 3)
    loader = t_loader.SampledLoader(
        g2, feat, labels, tcfg,
        t_loader.LoaderConfig(fanouts=(3, 2), batch_nodes=3, seed=0),
        train_nodes=seeds, start_thread=False)
    batch = loader.batch_for(0)
    np.testing.assert_array_equal(np.sort(batch.seeds), np.sort(seeds))
    step = t_loader.SampledTrainStep(tcfg, t_adamw.AdamWConfig(lr=1e-2))
    params = t_gnn.init_gnn_params(tcfg)
    _, m = step((params, t_adamw.adamw_init(params)), batch)
    assert np.isfinite(float(m["loss"]))


def test_bucket_reuse_counts_one_bucket(graphs):
    """Two batches with different raw sizes but one pow2 bucket share a
    key (one bucket) and the plan cache's config."""
    loader = _port_loader(graphs, 64, start_thread=False)
    batches = [loader.batch_for(s) for s in range(12)]
    by_key, pair = {}, None
    for b in batches:
        other = by_key.setdefault(b.key, b)
        if other is not b and other.raw_nodes != b.raw_nodes:
            pair = (other, b)
            break
    assert pair is not None
    _, tcfg = _cfgs("gcn", in_dim=4, hidden=4)
    step = t_loader.SampledTrainStep(tcfg, t_adamw.AdamWConfig(lr=1e-2))
    params = t_gnn.init_gnn_params(tcfg)
    state = (params, t_adamw.adamw_init(params))
    for b in pair:
        state, m = step(state, b)
        assert np.isfinite(float(m["loss"]))
    assert step.num_buckets == 1
    assert loader.stats()["cache"]["config_hits"] > 0
    for e0, e1 in zip(*(b.entries for b in pair)):
        assert e0.plan.config == e1.plan.config


def test_plan_cache_backward_and_heuristic_modes(graphs):
    """``with_backward`` keys and pads the transposed schedule; a
    ``config_fn`` replaces the tuner, with the cache's feat dtype, and is
    counted as the ``heuristic`` source."""
    _, tg = graphs
    kw = dict(arch="gcn", in_dim=8, hidden_dim=8, num_layers=2)
    fwd = PlanCache(backend="torch", device="cpu", tune_iters=2)
    calls = []

    def heuristic(g):
        calls.append(g.num_nodes)
        return t_loader.sampled_agg_config(g)

    train = PlanCache(backend="torch", device="cpu", with_backward=True,
                      config_fn=heuristic, feat_dtype="bfloat16",
                      registry=fwd.registry)
    e_fwd = fwd.get_or_build(tg, **kw)
    e_bwd = train.get_or_build(tg, **kw)
    assert e_fwd.plan.partition_bwd is None
    assert e_fwd.executor.sched_bwd is None
    assert e_bwd.fingerprint[-1][-1] == "bwd"
    assert e_bwd.fingerprint != e_fwd.fingerprint
    part_b = e_bwd.plan.partition_bwd
    assert part_b is not None and e_bwd.executor.sched_bwd is not None
    assert part_b.num_tiles == bucket_pow2(part_b.num_tiles)
    assert e_bwd.plan.config == dataclasses.replace(
        t_loader.sampled_agg_config(tg), feat_dtype="bfloat16")
    assert calls == [tg.num_nodes]
    # exact hit, then a same-shape-class graph: memo hit, no new call
    assert train.get_or_build(tg, **kw) is e_bwd
    g2 = tg.permute(np.random.default_rng(0).permutation(tg.num_nodes))
    e2 = train.get_or_build(g2, **kw)
    assert e2 is not e_bwd and calls == [tg.num_nodes]
    st = train.stats()
    assert (st["exact_hits"], st["config_hits"], st["misses"]) == (1, 1, 1)
    reg = fwd.registry
    built = {s: reg.get("plan_cache_builds_total", {"source": s}).value
             for s in ("tuner", "heuristic", "memo")}
    assert built == {"tuner": 1, "heuristic": 1, "memo": 1}


# ----------------------------------------------------------------- driver

def test_driver_sampled_fail_at_reproduces_clean_run(tmp_path):
    """--sampled --fail-at: crash at step 5, restore the step-4
    checkpoint, resync the loader and replay: the same parameters as an
    uninterrupted run, to atol 1e-6 (as the full-graph driver test)."""
    common = CPU + ["--arch", "gcn", "--sampled", "--dataset", "cora",
                    "--fanouts", "4,2", "--batch-nodes", "128",
                    "--hidden-dim", "8", "--steps", "7", "--ckpt-every", "4"]
    clean = t_train.run(common + ["--ckpt-dir", str(tmp_path / "a")])
    faulty = t_train.run(common + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--fail-at", "5"])
    assert faulty["trainer"].injector.fired == {5}
    assert faulty["stats"]["resyncs"] >= 1
    assert clean["ok"] and faulty["ok"] and len(clean["history"]) == 7
    p_clean, p_faulty = clean["trainer"].state[0], faulty["trainer"].state[0]
    for k in p_clean:
        torch.testing.assert_close(p_faulty[k], p_clean[k], rtol=0,
                                   atol=1e-6)
    assert clean["loader"]._thread is None


def test_driver_sampled_needs_cuda_unless_cpu_asked(tmp_path):
    """Without ``--device cpu`` the sampled branch runs on the card and,
    on a machine without one, raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.run(["--arch", "gcn", "--sampled", "--dataset", "cora",
                     "--steps", "1", "--ckpt-dir", str(tmp_path)])
    _, tcfg = _cfgs("gcn")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_loader.SampledLoader(
            t_csr.CSRGraph(np.zeros(2, np.int64), np.zeros(0, np.int32)),
            np.zeros((1, 8), np.float32), np.zeros(1, np.int32),
            dataclasses.replace(tcfg, device="cuda"),
            t_loader.LoaderConfig(fanouts=(1, 1), batch_nodes=1),
            start_thread=False)
