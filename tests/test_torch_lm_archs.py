"""Port LM parity for all ten architectures: `repro_torch.configs`,
`repro_torch.nn.transformer`, `repro_torch.models.lm` and
`repro_torch.launch.serve` against their `repro.*` counterparts on the
same carried weights (`lm_params_from_jax`) and numpy-made inputs.

Each arch's `reduced()` config: prefill logits and ``kvs`` leaf by leaf,
then 16 decode steps (logits every step, the whole cache after the
last).  The reference's Mamba slots run its Pallas scan in interpret
mode, the port's the scan wrapper's plain version (CPU tensors).

Tolerances, all in ``max|a-b| / (1 + max|b|)``: float32 1e-5, bfloat16
2e-2.  The normalized form, because the reference's initializer draws
the gated FFNs' ``wi`` (d, 2, d_ff) and the experts' at fan-in 2 (std
0.71): activations grow by orders of magnitude a layer, so rounding is
stated against the largest entry.  Prefill logits are held at those
limits for every arch.  The random gemma2 and jamba models amplify
rounding so far that ``kvs`` and decode (and in bfloat16 the logits too)
reach past them: those cells (`NOISY`) are held at 1e-4 / 1e-1, and
`test_reference_noise_floor_of_noisy_cells` shows why: the reference
itself moves past 1e-5 / 2e-2 when each weight is perturbed by one unit
in its last place."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import serve as j_serve
from repro.nn import layers as j_layers
from repro.models.lm import make_decode_step as j_make_decode_step
from repro.nn import transformer as j_tf

from repro_torch import configs as t_configs
from repro_torch.launch import serve as t_serve
from repro_torch.models.lm import (LMModel, lm_params_from_jax,
                                   make_decode_step, make_prefill_step)
from repro_torch.nn import layers as t_layers
from repro_torch.nn import transformer as t_tf

ARCHS = ["musicgen-large", "gemma2-2b", "gemma2-9b", "starcoder2-15b",
         "h2o-danube-1.8b", "jamba-v0.1-52b", "qwen3-moe-235b-a22b",
         "olmoe-1b-7b", "qwen2-vl-2b", "falcon-mamba-7b"]
BATCH, SEQ, DECODE_STEPS = 2, 64, 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NOISY_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
NOISY = {("gemma2-2b", "float32"), ("gemma2-9b", "float32"),
         ("jamba-v0.1-52b", "float32"), ("gemma2-2b", "bfloat16"),
         ("jamba-v0.1-52b", "bfloat16")}
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}   # the dtypes' eps
JAMBA_ONE_PERIOD = 13_295_235_072


def _tol(name, dtype):
    return NOISY_TOL[dtype] if (name, dtype) in NOISY else TOL[dtype]


def _nerr(a, b) -> float:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _configs(name: str, dtype: str = "float32"):
    j_cfg = j_configs.get_arch(name).reduced()
    t_cfg = t_configs.get_arch(name).reduced()
    if j_cfg.mamba is not None:
        j_cfg = dataclasses.replace(j_cfg, mamba=dataclasses.replace(
            j_cfg.mamba, pallas_scan="interpret"))
    if dtype == "bfloat16":
        j_cfg = dataclasses.replace(j_cfg, dtype=jnp.bfloat16)
        t_cfg = dataclasses.replace(t_cfg, dtype=torch.bfloat16)
    return j_cfg, t_cfg


def _carried(j_cfg, t_cfg, seed=0):
    params, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(seed))
    params_np = jax.tree.map(np.asarray, params)
    return params, lm_params_from_jax(params_np, t_cfg, device="cpu")


def _inputs(cfg, seed, seq=SEQ):
    """(inputs, pos) numpy: tokens or frames, and arange positions ((B,
    3, S) for mrope)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        inputs = rng.integers(0, cfg.vocab, (BATCH, seq)).astype(np.int32)
    else:
        inputs = rng.standard_normal((BATCH, seq, cfg.d_model)).astype(
            np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (BATCH, seq))
    if cfg.rope == "mrope":
        pos = np.broadcast_to(pos[:, None], (BATCH, 3, seq))
    return inputs, np.ascontiguousarray(pos)


def _ref_prefill(name, dtype):
    """(j_cfg, t_cfg, reference weights, port weights, a function of the
    reference weights giving (logits, kvs), the port's inputs)."""
    j_cfg, t_cfg = _configs(name, dtype)
    jp, tp = _carried(j_cfg, t_cfg, seed=1)
    inputs, pos = _inputs(j_cfg, seed=2)
    j_in = jnp.asarray(inputs, j_cfg.dtype if inputs.dtype == np.float32
                       else jnp.int32)
    step = jax.jit(lambda p, i, q: j_tf.lm_prefill(p, j_cfg, i, q))
    return (j_cfg, t_cfg, jp, tp,
            lambda p: step(p, j_in, jnp.asarray(pos)),
            (torch.from_numpy(inputs), torch.from_numpy(pos)))


def _prefill_check(name, dtype):
    j_cfg, t_cfg, jp, tp, ref, t_args = _ref_prefill(name, dtype)
    want, j_kvs = ref(jp)
    got, kvs = make_prefill_step(t_cfg, backend="torch")(tp, *t_args)
    assert got.dtype == torch.float32 and got.shape == (BATCH, j_cfg.vocab)
    assert bool(torch.isfinite(got).all())
    tol = _tol(name, dtype)
    assert _nerr(got, want) <= (TOL[dtype] if dtype == "float32" else tol)
    assert len(kvs) == len(j_kvs) == len(j_cfg.period)
    for spec, kv, j_kv in zip(t_cfg.period, kvs, j_kvs):
        if spec.kind != "attn":
            assert kv is None and j_kv is None
            continue
        for leaf, j_leaf in zip(kv, j_kv):
            assert tuple(leaf.shape) == j_leaf.shape == (
                t_cfg.repeats, BATCH, SEQ, t_cfg.n_kv, t_cfg.head_dim)
            assert leaf.dtype == t_cfg.dtype
            assert _nerr(leaf, np.asarray(j_leaf, np.float32)) <= tol


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name):
    _prefill_check(name, "float32")


@pytest.mark.parametrize("name", ["gemma2-2b", "jamba-v0.1-52b"])
def test_prefill_matches_reference_bfloat16(name):
    _prefill_check(name, "bfloat16")


def _feed(cfg, inputs, t, lib):
    x = inputs[:, t]
    if lib == "jax":
        return jnp.asarray(x, jnp.int32 if x.dtype != np.float32
                           else jnp.float32)
    return torch.from_numpy(np.ascontiguousarray(x))


def _cache_leaves(cache):
    for slot in cache:
        for k in sorted(slot):
            yield k, slot[k]


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_reference(name):
    j_cfg, t_cfg = _configs(name)
    jp, tp = _carried(j_cfg, t_cfg, seed=3)
    inputs, _ = _inputs(j_cfg, seed=4, seq=DECODE_STEPS)
    j_cache = j_tf.init_lm_cache(j_cfg, BATCH, max_seq=DECODE_STEPS,
                                 dtype=jnp.float32)
    t_cache = t_tf.init_lm_cache(t_cfg, BATCH, max_seq=DECODE_STEPS,
                                 dtype=torch.float32, device="cpu")
    j_step = jax.jit(lambda p, c, tok, t: j_tf.lm_decode_step(p, j_cfg, c,
                                                              tok, t))
    t_step = make_decode_step(t_cfg)
    worst = 0.0
    for t in range(DECODE_STEPS):
        j_logits, j_cache = j_step(jp, j_cache, _feed(j_cfg, inputs, t, "jax"),
                                   jnp.int32(t))
        t_logits, t_cache = t_step(tp, t_cache,
                                   _feed(j_cfg, inputs, t, "torch"), t)
        worst = max(worst, _nerr(t_logits, j_logits))
    tol = _tol(name, "float32")
    assert worst <= tol
    j_leaves, t_leaves = list(_cache_leaves(j_cache)), \
        list(_cache_leaves(t_cache))
    assert [k for k, _ in t_leaves] == [k for k, _ in j_leaves]
    for (k, leaf), (_, j_leaf) in zip(t_leaves, j_leaves):
        assert tuple(leaf.shape) == j_leaf.shape, k
        assert _nerr(leaf, j_leaf) <= tol, k


@pytest.mark.parametrize("name,dtype", sorted(NOISY))
def test_reference_noise_floor_of_noisy_cells(name, dtype):
    """The reference's prefill on its own weights against the same prefill
    with every weight multiplied by (1 + u z), u one unit in the last
    place of 1.0 in the dtype, z standard normal (three seeds): the
    largest move over the logits and the ``kvs`` exceeds the stated
    limit, so the port cannot be held to it in these cells."""
    _, _, jp, _, ref, _ = _ref_prefill(name, dtype)
    base = jax.tree.leaves(ref(jp))
    leaves, tdef = jax.tree.flatten(jp)
    moves = []
    for seed in range(3):
        keys = jax.random.split(jax.random.PRNGKey(100 + seed), len(leaves))
        bumped = [(w.astype(jnp.float32) * (1 + ULP[dtype] * jax.random.normal(
            k, w.shape))).astype(w.dtype) for w, k in zip(leaves, keys)]
        moved = jax.tree.leaves(ref(jax.tree.unflatten(tdef, bumped)))
        moves.append(max(_nerr(np.asarray(a, np.float32),
                               np.asarray(b, np.float32))
                         for a, b in zip(moved, base)))
    assert max(moves) > TOL[dtype]


def test_prefill_matches_decode_with_a_wrapping_ring():
    """gemma2-2b reduced with its local window cut to 16: 64 decode steps
    wrap the local layers' 16-slot ring four times; the last step's
    logits equal the prefill's (flash attention with the window) within
    1e-5."""
    _, t_cfg = _configs("gemma2-2b")
    t_cfg = dataclasses.replace(t_cfg, period=tuple(
        dataclasses.replace(s, window=16 if s.window else None)
        for s in t_cfg.period))
    params = LMModel.create(t_cfg, 5, device="cpu").params
    inputs, pos = _inputs(t_cfg, seed=6)
    want, _ = make_prefill_step(t_cfg, backend="torch")(
        params, torch.from_numpy(inputs), torch.from_numpy(pos))
    cache = t_tf.init_lm_cache(t_cfg, BATCH, max_seq=SEQ,
                               dtype=torch.float32, device="cpu")
    assert cache[0]["k"].shape[2] == 16 and cache[1]["k"].shape[2] == SEQ
    decode = make_decode_step(t_cfg)
    for t in range(SEQ):
        got, cache = decode(params, cache, torch.from_numpy(inputs[:, t]), t)
    assert _nerr(got, want.numpy()) <= 1e-5


def _serve_argv(name):
    return ["--arch", name, "--reduced", "--batch", "3", "--prompt-len", "6",
            "--gen-len", "10", "--seed", "0"]


@pytest.mark.parametrize("name", ["musicgen-large", "qwen2-vl-2b"])
def test_serve_driver_matches_reference_loop(name, capsys):
    """An ``embeds`` frontend (frames, then the seeded codebook) and the
    M-RoPE arch: greedy tokens equal the reference CLI's, logits equal
    its decode loop's at every step."""
    argv = _serve_argv(name)
    j_cfg, t_cfg = _configs(name)
    jp, tp = _carried(j_cfg, t_cfg, seed=0)   # the reference CLI's weights
    res = t_serve.run(argv + ["--device", "cpu"], params=tp,
                      keep_logits=True)
    out = capsys.readouterr().out
    assert re.search(rf"\[serve\] arch={t_cfg.name} batch=3 steps=16 "
                     r"tok/s=[0-9.]+", out)
    j_serve.main(argv)
    j_out = capsys.readouterr().out
    pat = r"seq\[\d\]: (\[[0-9, ]+\])"
    assert re.findall(pat, out) == re.findall(pat, j_out) != []

    rng = np.random.default_rng(0)
    frames = rng.standard_normal((3, 6, j_cfg.d_model)).astype(np.float32)
    codebook = rng.standard_normal((j_cfg.vocab, j_cfg.d_model)).astype(
        np.float32)
    decode, _, _ = j_make_decode_step(j_cfg)
    cache = j_tf.init_lm_cache(j_cfg, 3, max_seq=16, dtype=jnp.float32)
    prev, gen = jnp.zeros((3,), jnp.int32), []
    for t in range(16):
        x = jnp.asarray(frames[:, t]) if t < 6 else jnp.asarray(codebook)[prev]
        logits, cache = decode(jp, cache, x, jnp.int32(t))
        assert _nerr(res["logits"][t], logits) <= 1e-5, t
        prev = logits.argmax(-1).astype(jnp.int32)
        if t >= 5:
            gen.append(np.asarray(prev))
    np.testing.assert_array_equal(res["tokens"], np.stack(gen[:10], axis=1))


def _shape_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shape_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _meta_matches(j_cfg, t_cfg):
    j_shapes = jax.eval_shape(
        lambda: j_tf.lm_init(j_cfg, jax.random.PRNGKey(0))[0])
    model = LMModel.create(t_cfg, device="meta")
    p = model.params
    assert set(p) == set(j_shapes)
    for key in set(p) - {"blocks"}:
        for path, leaf in _shape_leaves(j_shapes[key]):
            t_leaf = p[key]
            for k in path:
                t_leaf = t_leaf[k]
            assert tuple(t_leaf.shape) == leaf.shape and t_leaf.is_meta
    R = t_cfg.repeats
    assert len(p["blocks"]) == R
    for s, j_slot in enumerate(j_shapes["blocks"]):
        for path, leaf in _shape_leaves(j_slot):
            for r in (0, R - 1):
                t_leaf = p["blocks"][r][s]
                for k in path:
                    t_leaf = t_leaf[k]
                assert (R,) + tuple(t_leaf.shape) == leaf.shape, path
                assert str(t_leaf.dtype).split(".")[-1] == str(leaf.dtype)
    return model.n_params, j_tf.param_count(j_shapes)


@pytest.mark.parametrize("name", ARCHS)
def test_full_config_on_meta_device_matches_reference(name):
    """`full()` on ``meta`` allocates nothing and has the reference's
    parameter count, leaf shapes and dtypes (bf16; MoE routers f32)."""
    n, j_n = _meta_matches(j_configs.get_arch(name).full(),
                           t_configs.get_arch(name).full())
    assert n == j_n


def test_jamba_one_period_holds_the_smoke_test_count():
    """The chip smoke test's Jamba (one period, 8 layers, full width)
    holds 13,295,235,072 parameters, the reference's count."""
    n, j_n = _meta_matches(
        dataclasses.replace(j_configs.get_arch("jamba-v0.1-52b").full(),
                            n_layers=8),
        dataclasses.replace(t_configs.get_arch("jamba-v0.1-52b").full(),
                            n_layers=8))
    assert n == j_n == JAMBA_ONE_PERIOD


@pytest.mark.parametrize("name", ARCHS)
def test_configs_port_line_for_line(name):
    """Every `LMConfig` field of both configs equal (torch dtypes for jnp
    ones); the Mamba scan switch is the port's own (``fused_scan``)."""
    for which in ("full", "reduced"):
        j_cfg = getattr(j_configs.get_arch(name), which)()
        t_cfg = getattr(t_configs.get_arch(name), which)()
        for f in dataclasses.fields(j_cfg):
            a, b = getattr(t_cfg, f.name), getattr(j_cfg, f.name)
            if f.name == "dtype":
                assert str(a).split(".")[-1] == np.dtype(b).name
            elif f.name == "mamba" and b is not None:
                assert {k: v for k, v in dataclasses.asdict(a).items()
                        if k != "fused_scan"} == {
                    k: v for k, v in dataclasses.asdict(b).items()
                    if k != "pallas_scan"}
            elif dataclasses.is_dataclass(b):
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            elif isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
                assert [dataclasses.asdict(x) for x in a] == \
                    [dataclasses.asdict(x) for x in b]
            else:
                assert a == b, f.name


def test_long_context_table_matches_reference():
    for name in ARCHS:
        t_arch, j_arch = t_configs.get_arch(name), j_configs.get_arch(name)
        assert t_arch.supports_long() == j_arch.supports_long(), name
        for shape in t_configs.SHAPES:
            assert t_configs.cell_is_runnable(t_arch, shape) == \
                j_configs.cell_is_runnable(j_arch, shape), (name, shape)


def test_registry_order_and_paper_gnn_configs():
    from repro.configs import paper_gnn as j_gnn
    from repro_torch.configs import paper_gnn as t_gnn
    assert t_configs.arch_names() == j_configs.arch_names() == ARCHS
    for key in ("gcn", "gin"):
        a, b = t_gnn.GNN_ARCHS[key](500, 3), j_gnn.GNN_ARCHS[key](500, 3)
        for f in ("arch", "in_dim", "hidden_dim", "num_classes",
                  "num_layers"):
            assert getattr(a, f) == getattr(b, f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_layers_match_reference(dtype):
    """`linear` (with bias), `layernorm`, the gated MLP (SiLU and tanh
    GELU) and the plain MLP on the reference's weights, biases and gains
    made non-zero."""
    rng = np.random.default_rng(9)
    init = j_layers.Initializer(jax.random.PRNGKey(9))
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    j_dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    t_dt = getattr(torch, dtype)

    def carried(p):
        p = {k: np.asarray(v) + (0 if k.startswith("w")
                                 else rng.standard_normal(v.shape) * 0.3)
             for k, v in p.items()}
        return ({k: jnp.asarray(v, j_dt) for k, v in p.items()},
                {k: torch.tensor(np.asarray(v, np.float32)).to(t_dt)
                 for k, v in p.items()})

    cases = [
        (j_layers.linear(init, 32, 24, bias=True)[0],
         j_layers.apply_linear, t_layers.apply_linear),
        (j_layers.layernorm(init, 32)[0], j_layers.apply_layernorm,
         t_layers.apply_layernorm),
        (j_layers.glu_mlp(init, 32, 48)[0], j_layers.apply_glu_mlp,
         t_layers.apply_glu_mlp),
        (j_layers.glu_mlp(init, 32, 48)[0],
         lambda p, x: j_layers.apply_glu_mlp(p, x, act=jax.nn.gelu),
         lambda p, x: t_layers.apply_glu_mlp(p, x, act=t_layers.gelu_tanh)),
        (j_layers.mlp(init, 32, 48)[0], j_layers.apply_mlp,
         t_layers.apply_mlp)]
    for p, j_fn, t_fn in cases:
        jp, tp = carried(p)
        want = j_fn(jp, jnp.asarray(x, j_dt))
        got = t_fn(tp, torch.from_numpy(x).to(t_dt))
        assert got.dtype == t_dt and tuple(got.shape) == want.shape
        assert _nerr(got, np.asarray(want, np.float32)) <= TOL[dtype]
