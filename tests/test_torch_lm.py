"""Port LM parity: falcon-mamba serving (`repro_torch.nn.transformer`,
`repro_torch.models.lm`, `repro_torch.launch.serve`) against
`repro.nn.transformer` / `repro.models.lm` / `repro.launch.serve` on the
same carried weights (`lm_params_from_jax`) and numpy-made tokens.

Tolerances.  Prefill logits in ``max|a-b| / (1 + |b|)``: float32 1e-5
(the reference's prefill runs its Pallas scan in interpret mode, the port
the scan wrapper's plain version; float32 rounding apart), bfloat16 2e-2
(the repo's bf16 limit: the two frameworks round bf16 products in
different places).  Decode, step by step, in ``max|a-b| / (1 + max|b|)``
at 1e-5 on logits and cache: the SSM states reach ~1e3 at the reduced
widths, so rounding of that size reaches the small logits and state
entries, which an elementwise ``/(1 + |b|)`` would blow up."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import falcon_mamba_7b as j_falcon
from repro.launch import serve as j_serve
from repro.models.lm import make_decode_step as j_make_decode_step
from repro.nn import transformer as j_tf

from repro_torch.configs import get_arch
from repro_torch.configs import falcon_mamba_7b as t_falcon
from repro_torch.kernels import selective_scan as t_scan
from repro_torch.launch import serve as t_serve
from repro_torch.models.lm import (LMModel, lm_params_from_jax,
                                   make_decode_step, make_prefill_step)
from repro_torch.nn import transformer as t_tf

BATCH, SEQ = 2, 64


def _err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _configs(dtype: str):
    j_cfg = j_falcon.reduced()
    t_cfg = t_falcon.reduced()
    if dtype == "bfloat16":
        j_cfg = dataclasses.replace(j_cfg, dtype=jnp.bfloat16)
        t_cfg = dataclasses.replace(t_cfg, dtype=torch.bfloat16)
    return j_cfg, t_cfg


def _carried(j_cfg, t_cfg, seed=0):
    params, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(seed))
    params_np = jax.tree.map(np.asarray, params)
    return params, lm_params_from_jax(params_np, t_cfg, device="cpu")


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ))


def _pos():
    return torch.arange(SEQ).expand(BATCH, SEQ)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_prefill_logits_match_reference(dtype, tol):
    j_cfg, t_cfg = _configs(dtype)
    j_cfg = dataclasses.replace(j_cfg, mamba=dataclasses.replace(
        j_cfg.mamba, pallas_scan="interpret"))
    jp, tp = _carried(j_cfg, t_cfg)
    toks = _tokens(j_cfg.vocab)
    pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32), (BATCH, SEQ))
    want, j_kvs = j_tf.lm_prefill(jp, j_cfg, jnp.asarray(toks, jnp.int32),
                                  pos)
    t_scan.reset_launches()
    got, kvs = make_prefill_step(t_cfg, backend="torch")(
        tp, torch.as_tensor(toks), _pos())
    assert got.dtype == torch.float32 and got.shape == (BATCH, j_cfg.vocab)
    assert kvs == (None,) and j_kvs == (None,)
    # one fused scan per layer, through the plain version
    assert t_scan.launches == {"selective_scan": 0,
                               "selective_scan_ref": t_cfg.n_layers}
    assert _err(got.numpy(), np.asarray(want)) <= tol


def test_prefill_backend_checks():
    """``backend="cuda"`` runs the scan kernel and needs CUDA tensors:
    on the CPU it raises, as the GNN path's does; an unknown backend
    raises."""
    _, t_cfg = _configs("float32")
    params = LMModel.create(t_cfg, 3, device="cpu").params
    toks = torch.as_tensor(_tokens(t_cfg.vocab, seed=4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        make_prefill_step(t_cfg, backend="cuda")(params, toks, _pos())
    with pytest.raises(ValueError, match="backend"):
        make_prefill_step(t_cfg, backend="xla")


def test_decode_steps_match_reference():
    j_cfg, t_cfg = _configs("float32")
    jp, tp = _carried(j_cfg, t_cfg, seed=2)
    toks = _tokens(j_cfg.vocab, seed=5)
    j_cache = j_tf.init_lm_cache(j_cfg, BATCH, max_seq=SEQ, dtype=jnp.float32)
    t_cache = t_tf.init_lm_cache(t_cfg, BATCH, max_seq=SEQ,
                                 dtype=torch.float32, device="cpu")
    j_step = jax.jit(lambda p, c, tok, t: j_tf.lm_decode_step(p, j_cfg, c,
                                                              tok, t))
    t_step = make_decode_step(t_cfg)
    worst = 0.0
    for t in range(SEQ):
        j_logits, j_cache = j_step(jp, j_cache,
                                   jnp.asarray(toks[:, t], jnp.int32),
                                   jnp.int32(t))
        t_logits, t_cache = t_step(tp, t_cache, torch.as_tensor(toks[:, t]),
                                   t)
        worst = max(worst, _nerr(t_logits.numpy(), np.asarray(j_logits)))
    assert worst <= 1e-5
    assert len(t_cache) == len(j_cache) == 1
    for k in ("h", "conv"):
        assert tuple(t_cache[0][k].shape) == j_cache[0][k].shape
        assert _nerr(t_cache[0][k].numpy(), np.asarray(j_cache[0][k])) <= 1e-5


def test_prefill_matches_decode_in_port():
    """The prefill's last-token logits (through the fused scan) equal the
    last of SEQ decode steps (the recurrence), float32."""
    _, t_cfg = _configs("float32")
    params = LMModel.create(t_cfg, 6, device="cpu").params
    toks = torch.as_tensor(_tokens(t_cfg.vocab, seed=7))
    want, _ = make_prefill_step(t_cfg, backend="torch")(params, toks, _pos())
    cache = t_tf.init_lm_cache(t_cfg, BATCH, max_seq=SEQ,
                               dtype=torch.float32, device="cpu")
    decode = make_decode_step(t_cfg)
    for t in range(SEQ):
        got, cache = decode(params, cache, toks[:, t], t)
    assert _err(got.numpy(), want.numpy()) <= 1e-4


def test_serve_driver_matches_reference_decode_loop(capsys):
    """Greedy tokens of the port's driver on carried weights equal the
    reference CLI's (same seed, same prompt); logits agree at every step
    with the reference's decode loop."""
    argv = ["--arch", "falcon-mamba-7b", "--reduced", "--batch", "3",
            "--prompt-len", "8", "--gen-len", "12", "--seed", "0"]
    j_cfg, t_cfg = _configs("float32")
    # the reference CLI's own weights: lm_init at PRNGKey(seed)
    jp, tp = _carried(j_cfg, t_cfg, seed=0)
    res = t_serve.run(argv + ["--device", "cpu"], params=tp,
                      keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] arch=falcon-mamba-reduced batch=3 steps=20 "
                     r"tok/s=[0-9.]+", out)
    assert res["tokens"].shape == (3, 12)

    j_serve.main(argv)
    j_out = capsys.readouterr().out
    j_seqs = re.findall(r"seq\[\d\]: (\[[0-9, ]+\])", j_out)
    t_seqs = re.findall(r"seq\[\d\]: (\[[0-9, ]+\])", out)
    assert len(j_seqs) == 2 and j_seqs == t_seqs

    # the reference's loop, step by step, on the same weights and prompt
    decode, _, _ = j_make_decode_step(j_cfg)
    cache = j_tf.init_lm_cache(j_cfg, 3, max_seq=20, dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(0, j_cfg.vocab, size=(3, 8))
    prev = jnp.zeros((3,), jnp.int32)
    gen = []
    for t in range(20):
        tok = jnp.asarray(prompt[:, t], jnp.int32) if t < 8 else prev
        logits, cache = decode(jp, cache, tok, jnp.int32(t))
        assert _nerr(res["logits"][t].numpy(), np.asarray(logits)) <= 1e-5, t
        prev = logits.argmax(-1).astype(jnp.int32)
        if t >= 7:
            gen.append(np.asarray(prev))
    np.testing.assert_array_equal(res["tokens"], np.stack(gen[:12], axis=1))


def test_serve_driver_samples_with_seeded_generator():
    argv = ["--arch", "falcon-mamba-7b", "--batch", "2", "--prompt-len", "4",
            "--gen-len", "6", "--temperature", "0.8", "--device", "cpu"]
    a = t_serve.run(argv)["tokens"]
    b = t_serve.run(argv)["tokens"]
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 6) and (a >= 0).all() and (a < 256).all()


def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shape_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_full_model_shapes_on_meta_device():
    """`full()` built on ``meta`` allocates nothing and holds exactly the
    reference's 7,272,665,088 parameters, leaf by leaf in shape (the
    reference's leading (R,) layer axis unstacked)."""
    j_shapes = jax.eval_shape(
        lambda: j_tf.lm_init(j_falcon.full(), jax.random.PRNGKey(0))[0])
    model = LMModel.create(t_falcon.full(), device="meta")
    assert j_tf.param_count(j_shapes) == 7_272_665_088
    assert model.n_params == 7_272_665_088
    p = model.params
    for key in ("embed", "unembed"):
        assert p[key].device.type == "meta"
        assert tuple(p[key].shape) == j_shapes[key].shape
    assert tuple(p["final_norm"]["g"].shape) == j_shapes["final_norm"]["g"].shape
    assert len(p["blocks"]) == 64
    (j_slot,) = j_shapes["blocks"]
    for path, leaf in _shape_leaves(j_slot):
        for r in range(64):
            t_leaf = p["blocks"][r][0]
            for k in path:
                t_leaf = t_leaf[k]
            assert (64,) + tuple(t_leaf.shape) == leaf.shape, path
            assert t_leaf.dtype == torch.bfloat16 and t_leaf.is_meta


def test_lm_params_from_jax_keeps_values_and_dtypes():
    j_cfg, t_cfg = _configs("bfloat16")
    jp, tp = _carried(j_cfg, t_cfg, seed=9)
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))
    j_in = np.asarray(jp["blocks"][0]["mamba"]["in_proj"], np.float32)
    for r in range(t_cfg.repeats):
        np.testing.assert_array_equal(
            tp["blocks"][r][0]["mamba"]["in_proj"].float().numpy(), j_in[r])


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        LMModel.create(t_falcon.reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        t_serve.run(["--arch", "falcon-mamba-7b"])


def test_get_arch_serves_every_arch():
    """All ten reference LM archs are registered (the port refused nine
    before the attention and MoE stack came); an unknown name raises
    `KeyError`, as the reference's registry does."""
    from repro.configs import ARCHS as j_archs
    assert len(j_archs) == 10
    for name in j_archs:
        assert get_arch(name).name == name
    assert get_arch("falcon-mamba-7b").full().n_layers == 64
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")
    with pytest.raises(ValueError, match="multiple of the period"):
        t_tf.LMConfig(name="odd", n_layers=3, d_model=8, vocab=16,
                      period=(t_tf.LayerSpec(), t_tf.LayerSpec()))
