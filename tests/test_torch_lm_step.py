"""The port's LM train step beyond one-step parity: remat modes,
micro-batching, the in-place (donated) update, the scan's gradient
refusal with the chunked path's gradients held to the reference, and the
``train --arch <lm>`` driver (every arch trains, the loss falls, restart
after an injected failure, ``--metrics-out`` / ``--trace-out``).

Tolerance ``max|a-b| / (1 + max|b|) <= 1e-5`` (float32) wherever two
computations take different rounding paths; ``torch.equal`` where they
take the same one.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.data import PipelineConfig, TokenPipeline, make_lm_batch
from repro.models.lm import make_train_step as j_make_train_step
from repro.nn import mamba as j_mamba
from repro.nn import transformer as j_tf
from repro.nn.layers import Initializer as JInitializer
from repro.optim import adamw as j_adamw

from repro_torch import configs as t_configs
from repro_torch.kernels import selective_scan as t_scan
from repro_torch.launch import train as t_train
from repro_torch.models.lm import (lm_params_from_jax, lm_params_to_jax,
                                   make_train_step, train_config)
from repro_torch.nn import mamba as t_mamba
from repro_torch.nn import transformer as t_tf
from repro_torch.optim import adamw as t_adamw
from repro_torch.runtime.checkpoint import _leaves, _rebuild

TOL = 1e-5
LR = 3e-3


def _nerr(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _setup(name, seed=1, batch=4, seq=64):
    """Reference weights and batch for ``name``'s reduced config, and the
    port's copies."""
    j_cfg = j_configs.get_arch(name).reduced()
    t_cfg = t_configs.get_arch(name).reduced()
    jp, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(seed))
    pipe = TokenPipeline(PipelineConfig(vocab=j_cfg.vocab, seq_len=seq,
                                        global_batch=batch, seed=seed))
    b = make_lm_batch(pipe.batch(0), frontend=j_cfg.frontend,
                      d_model=j_cfg.d_model, mrope=(j_cfg.rope == "mrope"),
                      seed=0)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), t_cfg,
                            device="cpu")
    return (j_cfg, jp, {k: jnp.asarray(v) for k, v in b.items()}, t_cfg, tp,
            {k: torch.from_numpy(v) for k, v in b.items()})


def _loss_and_grads(params, cfg, batch):
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    loss, _ = t_tf.lm_loss(_rebuild(params, iter(leaves)), cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              allow_unused=True,
                                              materialize_grads=True)


# ---------------------------------------------------------------------------
# remat, micro-batching, the donated update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "gemma2-2b"])
def test_remat_modes_give_equal_loss_and_gradients(name):
    """"full" (save the repeat's input), "dots" (also the matrix
    products) and "none" recompute the same float32 ops: bit-equal."""
    _, _, _, t_cfg, tp, tb = _setup(name)
    runs = {mode: _loss_and_grads(tp, train_config(dataclasses.replace(
        t_cfg, remat=mode)), tb) for mode in ("full", "dots", "none")}
    for mode in ("dots", "none"):
        assert torch.equal(runs[mode][0], runs["full"][0])
        assert all(torch.equal(a, b)
                   for a, b in zip(runs[mode][1], runs["full"][1]))


def test_remat_keeps_only_each_repeats_input():
    """Under "full" the saved activations are the repeats' inputs (and
    the loss's hidden state), far fewer than "none" saves."""
    _, _, _, t_cfg, tp, tb = _setup("h2o-danube-1.8b")
    saved = {}
    for mode in ("full", "none"):
        sizes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: sizes.append(t.numel()) or t, lambda t: t):
            t_tf.lm_loss(_rebuild(tp, iter([
                p.detach().requires_grad_() for p in _leaves(tp)])),
                dataclasses.replace(t_cfg, remat=mode), tb)
        saved[mode] = sum(sizes)
    assert saved["full"] * 4 < saved["none"]
    with pytest.raises(ValueError, match="remat"):
        t_tf.lm_forward(tp, dataclasses.replace(t_cfg, remat="some"),
                        tb["tokens"], tb["pos"])


def test_micro_batching_matches_one_batch_and_the_reference():
    """n_micro 2 against n_micro 1 in the port (the same step within
    1e-5) and against the reference's n_micro 2 step."""
    name = "falcon-mamba-7b"
    j_cfg, jp, jb, t_cfg, tp, tb = _setup(name, seed=2)
    opt_t = t_adamw.AdamWConfig(lr=LR)
    out = {}
    for n in (1, 2):
        params = _rebuild(tp, iter([p.clone() for p in _leaves(tp)]))
        out[n] = make_train_step(t_cfg, opt_t, n_micro=n).step(
            params, t_adamw.adamw_init(params), tb)
    j_new, j_state, j_m = j_make_train_step(
        j_cfg, j_adamw.AdamWConfig(lr=LR), n_micro=2, donate=False).step(
        jp, j_adamw.adamw_init(jp), jb)
    (p1, s1, m1), (p2, s2, m2) = out[1], out[2]
    for k in ("loss", "xent", "accuracy", "grad_norm"):
        assert _nerr(m2[k], m1[k]) <= TOL and _nerr(m2[k], j_m[k]) <= TOL, k
    assert all(_nerr(a, b) <= TOL for a, b in zip(_leaves(s2.m),
                                                  _leaves(s1.m)))
    for got, want in ((s2.m, j_state.m), (s2.v, j_state.v)):
        for a, b in zip(jax.tree.leaves(lm_params_to_jax(got, t_cfg)),
                        jax.tree.leaves(want)):
            assert _nerr(a, np.asarray(b)) <= TOL
    # new parameters: Adam's sign(g) lr, exempt where the gradient is
    # within the tolerance of zero (m holds 0.1 g on the first step)
    for a, b, m in zip(jax.tree.leaves(lm_params_to_jax(p2, t_cfg)),
                       jax.tree.leaves(j_new),
                       jax.tree.leaves(j_state.m)):
        b, m = np.asarray(b), np.asarray(m)
        near_zero = np.abs(m) <= 0.1 * TOL * (1 + np.abs(m / 0.1).max())
        diff = np.abs(a - b)
        assert (diff[~near_zero] <= TOL * (1 + np.abs(b).max())).all()
        assert (diff <= 2 * LR + TOL * (1 + np.abs(b).max())).all()


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_donated_step_updates_in_place_and_equals_the_copying_step(name):
    _, _, _, t_cfg, tp, tb = _setup(name, seed=3)
    opt = t_adamw.AdamWConfig(lr=LR, schedule=t_adamw.cosine_schedule(1, 3))
    copy = _rebuild(tp, iter([p.clone() for p in _leaves(tp)]))
    s_copy, s_don = t_adamw.adamw_init(copy), t_adamw.adamw_init(tp)
    before = _leaves(tp) + _leaves(s_don.m) + _leaves(s_don.v)
    donated = make_train_step(t_cfg, opt).step
    copying = make_train_step(t_cfg, opt, donate=False).step
    for _ in range(2):
        copy, s_copy, m_copy = copying(copy, s_copy, tb)
        params, s_don, m_don = donated(tp, s_don, tb)
        assert params is tp
    after = _leaves(params) + _leaves(s_don.m) + _leaves(s_don.v)
    assert all(a is b for a, b in zip(after, before))
    for a, b in zip(after, _leaves(copy) + _leaves(s_copy.m)
                    + _leaves(s_copy.v)):
        assert torch.equal(a, b)
    assert all(torch.equal(m_don[k], m_copy[k]) for k in m_copy)


# ---------------------------------------------------------------------------
# the scan refuses a gradient; training takes the chunked path
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrapper takes
    its CUDA path and a refusal raises before anything touches CUDA."""

    @property
    def is_cuda(self):
        return True


def _scan_args(requires_grad):
    rng = np.random.default_rng(0)
    B, S, di, N = 2, 8, 4, 3
    shapes = [(B, S, di), (B, S, di), (B, S, N), (B, S, N), (di, N), (di,),
              (di,)]
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    args[4].requires_grad_(requires_grad)
    return args


def test_scan_wrapper_refuses_a_gradient_on_either_device(monkeypatch):
    def load(name):
        raise AssertionError("the refusal must come before the build")

    monkeypatch.setattr(t_scan.build, "load", load)
    t_scan.reset_launches()
    for on_card in (False, True):
        args = _scan_args(requires_grad=True)
        if on_card:
            args[0] = args[0].as_subclass(_OnCard)
        with pytest.raises(NotImplementedError, match="fused_scan='off'"):
            t_scan.selective_scan(*args)
    assert sum(t_scan.launches.values()) == 0
    # under no_grad the same CPU call runs the plain version
    with torch.no_grad():
        y = t_scan.selective_scan(*_scan_args(requires_grad=True))
    assert y.shape == (2, 8, 4) and t_scan.launches[t_scan.PLAIN] == 1


D_MODEL = 16


def _mamba_block(seed=0, fused_scan="on"):
    mp = j_mamba.MambaParams(d_inner=32, d_state=8, chunk=8)
    jp, _ = j_mamba.mamba_init(JInitializer(jax.random.PRNGKey(seed),
                                            dtype=jnp.float32), D_MODEL, mp)
    tmp = t_mamba.MambaParams(d_inner=32, d_state=8, chunk=8,
                              fused_scan=fused_scan)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 32, D_MODEL)).astype(np.float32)
    return mp, jp, tmp, tp, x


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_mamba_refuses_a_gradient(backend):
    _, _, tmp, tp, x = _mamba_block()
    tx = torch.from_numpy(x)
    with pytest.raises(NotImplementedError, match="fused_scan='off'"):
        t_mamba.mamba_forward(tp, tx.clone().requires_grad_(), tmp,
                              backend=backend)
    tp["A_log"].requires_grad_()
    with pytest.raises(NotImplementedError, match="fused_scan='off'"):
        t_mamba.mamba_forward(tp, tx, tmp, backend=backend)
    if backend == "torch":
        with torch.no_grad():
            assert t_mamba.mamba_forward(tp, tx, tmp,
                                         backend=backend).shape == x.shape


def test_chunked_mamba_gradients_match_reference():
    mp, jp, tmp, tp, x = _mamba_block(seed=2, fused_scan="off")
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, a: j_mamba.mamba_forward(p, a, mp), jp,
                     jnp.asarray(x))
    j_dp, j_dx = vjp(jnp.asarray(g))
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = t_mamba.mamba_forward(leaves, tx, tmp, backend="cuda")
    got = torch.autograd.grad(y, [tx] + list(leaves.values()),
                              torch.from_numpy(g))
    assert _nerr(got[0], np.asarray(j_dx)) <= TOL
    for (k, _), d in zip(leaves.items(), got[1:]):
        assert _nerr(d, np.asarray(j_dp[k])) <= TOL, k


def test_training_rewrites_mamba_to_the_chunked_path():
    _, _, _, t_cfg, tp, tb = _setup("falcon-mamba-7b")
    assert t_cfg.mamba.fused_scan == "on"
    assert train_config(t_cfg).mamba.fused_scan == "off"
    h2o = t_configs.get_arch("h2o-danube-1.8b").reduced()
    assert train_config(h2o) is h2o
    with pytest.raises(NotImplementedError, match="fused_scan='off'"):
        _loss_and_grads(tp, t_cfg, tb)
    t_scan.reset_launches()
    _, _, m = make_train_step(t_cfg, t_adamw.AdamWConfig(lr=LR)).step(
        tp, t_adamw.adamw_init(tp), tb)
    assert np.isfinite(float(m["loss"]))
    assert sum(t_scan.launches.values()) == 0


# ---------------------------------------------------------------------------
# the training driver (launch/train.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", t_configs.arch_names())
def test_driver_trains_every_lm_arch_on_the_cpu(name, tmp_path):
    res = t_train.run(["--arch", name, "--reduced", "--steps", "2",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert res["ok"] and len(res["history"]) == 2
    assert res["cfg"].name == t_configs.get_arch(name).reduced().name
    assert {"loss", "xent", "accuracy", "aux_loss", "grad_norm", "lr",
            "tokens"} <= set(res["history"][0])


def test_driver_loss_falls_and_says_mamba_trains_chunked(tmp_path, capsys):
    res = t_train.run(["--arch", "falcon-mamba-7b", "--reduced", "--steps",
                       "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["ok"] and res["last_loss"] < res["first_loss"]
    assert "chunked path (fused_scan='off')" in out
    assert "[train] arch=falcon-mamba-reduced steps=3 first_loss=" in out
    # init_params is a host copy of the parameters the run started from
    init, final = _leaves(res["init_params"]), _leaves(res["trainer"].state[0])
    assert [a.shape for a in init] == [b.shape for b in final]
    assert all(a.device.type == "cpu" for a in init)
    assert not any(torch.equal(a, b) for a, b in zip(init, final)
                   if a.ndim >= 2)


def test_driver_resumes_after_an_injected_failure(tmp_path, capsys):
    common = ["--arch", "jamba-v0.1-52b", "--reduced", "--steps", "4",
              "--device", "cpu", "--ckpt-every", "2", "--n-micro", "2"]
    clean = t_train.run(common + ["--ckpt-dir", str(tmp_path / "a")])
    faulty = t_train.run(common + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--fail-at", "2"])
    assert faulty["trainer"].injector.fired == {2}
    assert "restored checkpoint step=2" in capsys.readouterr().out
    for got, want in ((faulty["trainer"].state, clean["trainer"].state),):
        for a, b in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a, b)
    assert [m["loss"] for m in faulty["history"][-2:]] == \
        [m["loss"] for m in clean["history"][-2:]]


def test_driver_writes_metrics_and_trace(tmp_path):
    metrics, trace = tmp_path / "m.json", tmp_path / "t.json"
    res = t_train.run(["--arch", "olmoe-1b-7b", "--steps", "2", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path / "c"),
                       "--metrics-out", str(metrics), "--trace-out",
                       str(trace)])
    assert res["ok"]
    doc = json.loads(metrics.read_text())
    assert "train_steps_total" in json.dumps(doc)
    events = json.loads(trace.read_text())["traceEvents"]
    assert {"train", "train/step", "train/step/batch"} <= {
        e.get("name") for e in events}


@pytest.mark.parametrize("flags,msg", [
    (["--arch", "gemma2-2b", "--sampled"], "gcn/gin only"),
    (["--arch", "gemma2-2b", "--shards", "2"], "gcn/gin only"),
    (["--arch", "gemma2-2b", "--n-micro", "3"], "divide --global-batch"),
    (["--arch", "llama-7b"], "unknown arch"),
])
def test_driver_refuses_lm_flags_it_cannot_run(flags, msg, capsys):
    with pytest.raises(SystemExit):
        t_train.parse_args(flags)
    assert msg in capsys.readouterr().err
