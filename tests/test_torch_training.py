"""Port training parity: AdamW and its schedules, full-graph train steps,
checkpoints, the fault-tolerant trainer and the training driver, against
the JAX package where it has a counterpart (same inputs, made with numpy
from a seed, carried across with `params_from_jax` / `opt_state_from_jax`).

The port runs on the CPU with its plain PyTorch versions
(``device="cpu"``, ``backend="torch"``).  Tolerances, stated per test:
  * one AdamW step: rtol/atol 1e-6 (float32 elementwise arithmetic; the
    reference's XLA and PyTorch differ only in rounding of pow/sqrt);
  * train steps: ``max|a-b| / (1 + |b|) <= 1e-5`` on losses and
    parameters (float32 sums in another order, three steps deep).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
import repro.models.gnn as j_gnn
import repro.optim.adamw as j_adamw
from repro.core.model import AggConfig as JAggConfig

from repro_torch.core.model import AggConfig
from repro_torch.launch import train as t_train
from repro_torch.models import gnn as t_gnn
from repro_torch.optim import adamw as t_adamw
from repro_torch.runtime.checkpoint import (AsyncCheckpointer,
                                            CheckpointError, available_steps,
                                            latest_step, restore_checkpoint,
                                            save_checkpoint)
from repro_torch.runtime.trainer import FailureInjector, Trainer, TrainerConfig


def _normalized_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w0": rng.standard_normal((6, 4)).astype(np.float32),
            "w0b": rng.standard_normal((4, 3)).astype(np.float32),
            "a0s": rng.standard_normal(4).astype(np.float32)}


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_steps_match_reference(clip):
    """Two steps from a reference state: clipping before the moments,
    decay only on matrices, bias correction, schedule values."""
    rng = np.random.default_rng(0)
    params, g1, g2 = _tree(rng), _tree(rng), _tree(rng)
    jcfg = j_adamw.AdamWConfig(lr=1e-2, weight_decay=0.3, grad_clip=clip,
                               schedule=j_adamw.cosine_schedule(1, 10))
    tcfg = t_adamw.AdamWConfig(lr=1e-2, weight_decay=0.3, grad_clip=clip,
                               schedule=t_adamw.cosine_schedule(1, 10))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = j_adamw.adamw_init(jp)
    tp = t_gnn.params_from_jax(params, "cpu")
    ts = t_adamw.adamw_init(tp)
    for g in (g1, g2):
        jp, js, jm = j_adamw.adamw_update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts, tm = t_adamw.adamw_update(
            tcfg, t_gnn.params_from_jax(g, "cpu"), ts, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(ts.m[k].numpy(), js.m[k], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(ts.v[k].numpy(), js.v[k], rtol=1e-6,
                                       atol=1e-6)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 2
    # the reference's state carried across continues identically
    carried = t_adamw.opt_state_from_jax(js, "cpu")
    assert carried.step.dtype == torch.int32 and int(carried.step) == 2
    for k in params:
        np.testing.assert_array_equal(carried.m[k].numpy(), np.asarray(js.m[k]))


def test_adamw_decays_matrices_only():
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    cfg = t_adamw.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=None)
    new, _, _ = t_adamw.adamw_update(cfg, g, t_adamw.adamw_init(p), p)
    torch.testing.assert_close(new["w"], torch.full((2, 2), 0.95))
    torch.testing.assert_close(new["b"], torch.ones(2))
    assert torch.equal(p["w"], torch.ones(2, 2))      # inputs untouched


@pytest.mark.parametrize("step", [0, 1, 3, 7, 10, 25])
def test_schedules_match_reference(step):
    for jf, tf in ((j_adamw.cosine_schedule(5, 20, 0.2),
                    t_adamw.cosine_schedule(5, 20, 0.2)),
                   (j_adamw.linear_warmup(4), t_adamw.linear_warmup(4))):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        assert abs(float(tf(step)) - want) <= 1e-6
        assert abs(float(tf(torch.tensor(step, dtype=torch.int32)))
                   - want) <= 1e-6


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    g = _tree(rng)
    jc, jn = j_adamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    tc, tn = t_adamw.clip_by_global_norm(t_gnn.params_from_jax(g, "cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), jc[k], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# full-graph train steps against the reference's jitted step
# ---------------------------------------------------------------------------

CFG = dict(gs=8, gpt=8, dt=64, src_win=128)


@pytest.mark.parametrize("arch,variant", [("gcn", "folded"),
                                          ("gat", "direct")])
def test_train_steps_match_reference(arch, variant):
    g = j_csr.random_power_law(240, 5.0, seed=21)
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=20, hidden_dim=12,
                           num_classes=4, num_layers=2, backend="xla")
    jm = j_gnn.build_gnn(g, jcfg, reorder="on",
                         config=JAggConfig(**CFG, variant=variant),
                         key=jax.random.PRNGKey(5))
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=20, hidden_dim=12,
                           num_classes=4, num_layers=2, backend="torch",
                           device="cpu")
    tm = t_gnn.build_gnn(g, tcfg, reorder="on",
                         config=AggConfig(**CFG, variant=variant),
                         with_backward=True)
    rng = np.random.default_rng(6)
    feat = jm.plan.renumber_features(
        rng.standard_normal((g.num_nodes, 20)).astype(np.float32))
    labels = jm.plan.renumber_features(
        rng.integers(0, 4, g.num_nodes).astype(np.int32))
    jopt = j_adamw.AdamWConfig(lr=1e-2,
                               schedule=j_adamw.cosine_schedule(1, 3))
    topt = t_adamw.AdamWConfig(lr=1e-2,
                               schedule=t_adamw.cosine_schedule(1, 3))
    jstep = j_gnn.make_gnn_train_step(jm, jopt)
    tstep = t_gnn.make_gnn_train_step(tm, topt)
    jstate = (jm.params, j_adamw.adamw_init(jm.params))
    tparams = t_gnn.params_from_jax(
        {k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    tstate = (tparams, t_adamw.adamw_init(tparams))
    jb = {"feat": jnp.asarray(feat), "labels": jnp.asarray(labels)}
    tb = {"feat": torch.from_numpy(feat),
          "labels": torch.from_numpy(labels).long()}
    for _ in range(3):
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        assert _normalized_err(float(tmet["loss"]), float(jmet["loss"])) \
            <= 1e-5
        assert set(tmet) == {"loss", "accuracy", "grad_norm", "lr"}
    for k in jstate[0]:
        assert _normalized_err(tstate[0][k].numpy(), jstate[0][k]) <= 1e-5, k
    assert int(tstate[1].step) == 3


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w0": torch.randn(8, 4, generator=gen),
              "a0s": torch.randn(4, generator=gen)}
    return (params, t_adamw.adamw_init(params))


def _assert_same(a, b):
    from repro_torch.runtime.checkpoint import _leaves
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    t = _state()
    save_checkpoint(str(tmp_path), 7, t, metadata={"note": "x"})
    like = _state(seed=1)
    got, meta = restore_checkpoint(str(tmp_path), like)
    _assert_same(got, t)
    assert isinstance(got[1], t_adamw.OptState) and meta == {"note": "x"}
    assert latest_step(str(tmp_path)) == 7
    # the reference's layout: manifest with one sha256 per leaf
    import json
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        man = json.load(f)
    assert man["num_leaves"] == 7 and all(len(x["sha256"]) == 64
                                          for x in man["leaves"])


def test_checkpoint_bf16_leaf_restores_dtype(tmp_path):
    t = {"x": torch.randn(3, 2).to(torch.bfloat16), "n": torch.tensor(3)}
    save_checkpoint(str(tmp_path), 1, t)
    got, _ = restore_checkpoint(str(tmp_path), t)
    _assert_same(got, t)


def test_checkpoint_gc_keeps_last(tmp_path):
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(str(tmp_path), s, _state(), keep=2)
    assert available_steps(str(tmp_path)) == [4, 5]


def test_checkpoint_integrity_detection(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, _state())
    leaf = os.path.join(path, "leaf_00000.npy")
    arr = np.load(leaf)
    arr.reshape(-1)[0] += 1.0
    np.save(leaf, arr)
    with pytest.raises(CheckpointError, match="integrity"):
        restore_checkpoint(str(tmp_path), _state())


def test_partial_write_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state())
    os.makedirs(tmp_path / "step_00000002.tmp-dead")
    os.makedirs(tmp_path / "step_00000003")       # no manifest
    assert latest_step(str(tmp_path)) == 1


def test_async_checkpointer_and_structure_mismatch(tmp_path):
    t = _state()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, t)
    ck.wait()
    got, _ = restore_checkpoint(str(tmp_path), t)
    _assert_same(got, t)
    with pytest.raises(CheckpointError, match="leaf count"):
        restore_checkpoint(str(tmp_path), {"only": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the trainer: restart determinism
# ---------------------------------------------------------------------------

def _make_trainer(tmp_path, fail_at=(), tag="a"):
    """Tiny quadratic 'training': state = {"w"}."""
    target = torch.tensor([1.0, -2.0, 0.5])

    def step_fn(state, batch):
        w = state["w"]
        w = w - 0.1 * (2 * (w - target) + 0.01 * batch)
        return dict(state, w=w), {"loss": ((w - target) ** 2).sum()}

    def batch_fn(step):
        return torch.from_numpy(
            np.random.default_rng(step).standard_normal(3).astype(np.float32))

    return Trainer(
        TrainerConfig(ckpt_dir=str(tmp_path / f"ck_{tag}"), ckpt_every=5,
                      log_every=1000),
        step_fn, batch_fn, {"w": torch.zeros(3)},
        injector=FailureInjector(fail_at), log_fn=lambda s: None)


def test_trainer_restart_determinism(tmp_path):
    clean = _make_trainer(tmp_path, tag="clean")
    clean.run(30)
    faulty = _make_trainer(tmp_path, fail_at=(12, 23), tag="faulty")
    faulty.run(30)
    assert torch.equal(clean.state["w"], faulty.state["w"])
    assert faulty.injector.fired == {12, 23}
    assert faulty.registry.counter("train_restores_total").value == 2


def test_trainer_resume_from_disk(tmp_path):
    t1 = _make_trainer(tmp_path, tag="resume")
    t1.run(10)
    t2 = _make_trainer(tmp_path, tag="resume")
    assert t2.step == 10
    t2.run(5)
    assert t2.step == 15


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

CPU = ["--device", "cpu", "--backend", "torch", "--dataset", "cora",
       "--max-nodes", "300", "--hidden-dim", "16", "--lr", "1e-2",
       "--warmup", "2"]


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_driver_cpu_smoke_loss_falls(arch, tmp_path):
    res = t_train.run(CPU + ["--arch", arch, "--steps", "20", "--ckpt-dir",
                             str(tmp_path / "ck")])
    losses = [m["loss"] for m in res["history"]]
    assert res["ok"] and len(losses) == 20
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert res["model"].executor.device == torch.device("cpu")
    assert res["doc"]["metrics"]


@pytest.mark.parametrize("arch,variant", [("gcn", "folded"),
                                          ("gin", "direct")])
def test_driver_cpu_sampled_smoke(arch, variant, tmp_path):
    """``--sampled`` on the CPU with the reference's default fanouts and
    batch (512 seeds, capped here to the 300 nodes): a finite loss every
    step, the plans stamped with ``--variant``.  Without ``--max-nodes``
    the sampled branch is uncapped."""
    assert t_train.parse_args(["--arch", "gcn", "--sampled"]).max_nodes \
        is None
    res = t_train.run(CPU + ["--arch", arch, "--sampled", "--steps", "5",
                             "--variant", variant,
                             "--ckpt-dir", str(tmp_path / "ck")])
    losses = [m["loss"] for m in res["history"]]
    assert res["ok"] and len(losses) == 5 and np.isfinite(losses).all()
    assert res["loader"].g.num_nodes == 300
    assert res["cfg"].num_layers == 2 and res["cfg"].in_dim == 128
    assert res["stats"]["num_buckets"] >= 1 and res["doc"]["metrics"]
    assert {e.plan.config.variant
            for e in res["loader"].batch_for(0).entries} == {variant}


def test_driver_fail_at_reproduces_clean_run(tmp_path):
    """--fail-at: crash, restore the step-5 checkpoint, replay: the same
    parameters as an uninterrupted run, to atol 1e-6 (the reference's
    limit; two clean CPU runs already differ by ~1e-7, because threaded
    float32 reductions do not fix their order)."""
    common = CPU + ["--arch", "gcn", "--steps", "9", "--ckpt-every", "5"]
    clean = t_train.run(common + ["--ckpt-dir", str(tmp_path / "a")])
    faulty = t_train.run(common + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--fail-at", "7"])
    assert faulty["trainer"].injector.fired == {7}
    p_clean, p_faulty = clean["trainer"].state[0], faulty["trainer"].state[0]
    for k in p_clean:
        torch.testing.assert_close(p_faulty[k], p_clean[k], rtol=0,
                                   atol=1e-6)
    # a rerun in the same directory resumes at the last checkpoint (step
    # 5) and runs --steps more, as the reference's trainer does
    again = t_train.run(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert again["trainer"].step == 14 and len(again["history"]) == 9


@pytest.mark.parametrize("flags,msg", [
    (["--arch", "gat", "--sampled"], "gcn/gin only"),
    (["--arch", "h2o-danube-1.8b", "--shards", "2"], "gcn/gin only"),
    (["--arch", "gcn", "--stream-deltas", "2"], "requires --sampled"),
    (["--arch", "gat", "--shards", "2"], "gcn/gin only"),
    (["--arch", "mamba2-130m"], "unknown arch"),
    (["--arch", "gcn", "--shards", "2", "--dist-backend", "nccl",
      "--device", "cpu"], "--dist-backend gloo"),
])
def test_driver_refuses_unported_paths(flags, msg, capsys):
    with pytest.raises(SystemExit):
        t_train.parse_args(flags)
    assert msg in capsys.readouterr().err


def test_driver_and_model_need_cuda_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.run(["--arch", "gcn", "--max-nodes", "100", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])
    g = j_csr.random_power_law(50, 3.0, seed=0)
    cfg = t_gnn.GNNConfig(arch="gat", in_dim=4, hidden_dim=4, num_classes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_gnn.build_gnn(g, cfg, reorder="off",
                        config=AggConfig(gs=4, gpt=8, dt=8, src_win=64))
    ok = t_gnn.build_gnn(g, dataclasses.replace(cfg, device="cpu"),
                         reorder="off",
                         config=AggConfig(gs=4, gpt=8, dt=8, src_win=64))
    # the default backend is "cuda": the backward pair is attached
    assert ok.plan.partition_bwd is not None
    assert ok.executor.sched_bwd.device == torch.device("cpu")


def test_planted_and_structural_labels():
    g = j_csr.random_power_law(200, 4.0, seed=3)
    cfg = t_gnn.GNNConfig(arch="gcn", in_dim=8, hidden_dim=8, num_classes=3,
                          backend="torch", device="cpu")
    feat = np.random.default_rng(0).standard_normal((200, 8)).astype(
        np.float32)
    a = t_gnn.planted_labels(g, cfg, feat, seed=7)
    assert a.shape == (200,) and set(np.unique(a)) <= {0, 1, 2}
    assert np.array_equal(a, t_gnn.planted_labels(g, cfg, feat, seed=7))
    np.testing.assert_array_equal(t_gnn.structural_labels(g, 4),
                                  j_gnn.structural_labels(g, 4))
