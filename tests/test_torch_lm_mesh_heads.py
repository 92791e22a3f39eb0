"""Attention replicated over ``model`` on gloo ranks on the CPU: the
``mesh=`` paths of `repro_torch.models.lm` where the model axis does not
divide the query heads (`repro_torch.nn.tensor_parallel._replicated`:
the pruned specs keep no ``model`` axis on the heads, so every model rank
computes all H query heads and all K kv heads with ``wo`` whole), held
against the reference's single-device results on carried weights
(`lm_params_from_jax`) and numpy-made inputs.

Cases, head counts set with `dataclasses.replace` on both packages'
reduced configs:

  * gemma2-2b with H 2 / K 1 on (1, 4): fewer heads than model ranks, as
    gemma2-2b's 8 heads on the production model axis of 16 (softcaps,
    post-norms, a sliding window, tied embeddings);
  * qwen2-vl-2b with H 6 / K 2 on (1, 4): more heads than ranks but not
    a multiple, as its 12 heads on 16 (M-RoPE, q / k / v biases, an
    ``embeds`` frontend);
  * h2o-danube-1.8b with H 3 / K 1 on (2, 2): the batch split over
    ``data`` as well.

Each case's kv cache splits over the sequence on ``model`` (K does not
divide either).  Checked: prefill's last-token logits and ``kvs`` and 8
decode steps from step 0 against `repro.nn.transformer.lm_prefill` /
`lm_decode_step`, then one train step's loss and gradient against the
reference's `make_train_step` (the gradients read as in
`tests/test_torch_lm_mesh_train.py`), with ``seq_shard_carry`` off and
on, under remat (``"full"``, the configs' default; ``"dots"`` once):
the backward must count each rank's contribution once, neither summing
a whole gradient over ``model`` nor leaving a partial one unsummed.

Tolerances in ``max|a-b| / (1 + max|b|)``, float32, those of the mesh
tests beside this file: serving 1e-5 (gemma2-2b 1e-4, whose random
weights amplify rounding past 1e-5 on one device too), training 1e-4
(gemma2-2b 1e-3 against the reference and 1e-4 against the one-device
port, as `tests/test_torch_lm_mesh_train.py` holds it)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.data import PipelineConfig, TokenPipeline, make_lm_batch
from repro.models.lm import make_train_step as j_make_train_step
from repro.nn import transformer as j_tf
from repro.optim import adamw as j_adamw

from repro_torch import configs as t_configs
from repro_torch.distributed.sharding import (tree_flatten, tree_leaves,
                                              tree_unflatten)
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import (lm_params_from_jax, lm_params_to_jax,
                                   make_decode_step, make_prefill_step,
                                   make_train_step)
from repro_torch.nn.tensor_parallel import _split
from repro_torch.nn.transformer import init_lm_cache, lm_param_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.elastic import gather, reshard

BATCH, SEQ, DECODE_STEPS = 2, 32, 8
TRAIN_BATCH, N_MICRO = 4, 2
TOL = 1e-5
TRAIN_TOL = 1e-4
NOISY = {"gemma2-2b": (1e-4, 1e-3)}      # (serving, training vs reference)
LINEAR = AdamWConfig(lr=1.0, eps=1.0, weight_decay=0.0, grad_clip=None)
DEFAULT = AdamWConfig()
CASES = [("gemma2-2b", 2, 1, (1, 4)), ("qwen2-vl-2b", 6, 2, (1, 4)),
         ("h2o-danube-1.8b", 3, 1, (2, 2))]
IDS = [f"{c[0]}-H{c[1]}-K{c[2]}" for c in CASES]


def _nerr(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().float() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


@pytest.fixture(scope="module")
def meshes():
    return {(2, 2): make_mesh((2, 2), ("data", "model"), device="cpu"),
            (1, 4): make_mesh((1, 4), ("data", "model"), device="cpu")}


def _configs(name: str, H: int, K: int):
    return (dataclasses.replace(j_configs.get_arch(name).reduced(),
                                n_heads=H, n_kv=K),
            dataclasses.replace(t_configs.get_arch(name).reduced(),
                                n_heads=H, n_kv=K))


def _inputs(cfg, seed):
    """(inputs, pos) numpy: tokens or embeds, arange positions ((B, 3, S)
    for M-RoPE)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        inputs = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    else:
        inputs = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(
            np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (BATCH, SEQ))
    if cfg.rope == "mrope":
        pos = np.broadcast_to(pos[:, None], (BATCH, 3, SEQ))
    return inputs, np.ascontiguousarray(pos)


def _jnp(x: np.ndarray):
    return jnp.asarray(x, jnp.float32 if x.dtype == np.float32
                       else jnp.int32)


def _assert_replicated(step, t_cfg):
    """The pruned specs keep no ``model`` axis on the heads of any
    attention slot."""
    for slots in step.pspecs["blocks"]:
        for spec, sp in zip(t_cfg.period, slots):
            if spec.kind == "attn":
                assert sp["attn"]["wq"][1] is None
                assert sp["attn"]["wo"][0] is None


@pytest.mark.parametrize("name,H,K,shape", CASES, ids=IDS)
def test_mesh_prefill_and_decode_match_reference(meshes, name, H, K, shape):
    """`make_prefill_step(mesh=)`: last-token logits and the gathered kvs
    against the reference's single-device `lm_prefill`;
    `make_decode_step(mesh=)`: every step's logits from step 0 and the
    gathered cache after the last against `lm_decode_step`."""
    mesh = meshes[shape]
    tol = NOISY.get(name, (TOL,))[0]
    j_cfg, t_cfg = _configs(name, H, K)
    jp, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), t_cfg,
                                device="cpu")
    inputs, pos = _inputs(j_cfg, seed=2)
    want, j_kvs = jax.jit(lambda p, i, q: j_tf.lm_prefill(p, j_cfg, i, q))(
        jp, _jnp(inputs), jnp.asarray(pos))

    specs = lm_param_specs(t_cfg)
    prefill, _ = make_prefill_step(t_cfg, mesh=mesh, param_specs=specs,
                                   params_shape=params, backend="torch")
    _assert_replicated(prefill, t_cfg)
    handle = reshard(params, mesh, prefill.pspecs)
    got, kvs = prefill(handle, torch.from_numpy(inputs),
                       torch.from_numpy(pos))
    assert got.shape == (BATCH, t_cfg.vocab) and got.dtype == torch.float32
    assert _nerr(got, want) <= tol
    for t_kv, j_kv in zip(gather(kvs), j_kvs):
        for a, b in zip(t_kv, j_kv):
            assert tuple(a.shape) == b.shape
            assert _nerr(a, np.asarray(b)) <= tol
    assert tuple(kvs.specs[0][0]) == (None, "data", "model", None, None)

    j_cache = j_tf.init_lm_cache(j_cfg, BATCH, max_seq=DECODE_STEPS,
                                 dtype=jnp.float32)
    cache = init_lm_cache(t_cfg, BATCH, max_seq=DECODE_STEPS,
                          dtype=torch.float32, device="cpu")
    decode, _, _ = make_decode_step(t_cfg, mesh=mesh, param_specs=specs,
                                    params_shape=params, cache_shape=cache)
    j_step = jax.jit(lambda p, c, tok, t: j_tf.lm_decode_step(
        p, j_cfg, c, tok, t))
    for t in range(DECODE_STEPS):
        x = np.ascontiguousarray(inputs[:, t])
        want, j_cache = j_step(jp, j_cache, _jnp(x), jnp.int32(t))
        got, cache = decode(handle, cache, torch.from_numpy(x), t)
        assert _nerr(got, want) <= tol, t
    for t_slot, j_slot in zip(gather(cache), j_cache):
        for k in t_slot:
            assert _nerr(t_slot[k], np.asarray(j_slot[k])) <= tol, k


# ---------------------------------------------------------------------------
# the train step


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference(name: str, H: int, K: int):
    """The reference's weights, batch, one default step's metrics and its
    gradient (from the first moment: ``m = (1 - b1) g s``, ``s`` the
    clipping scale at its ``grad_norm``); one compile per case."""
    j_cfg, _ = _configs(name, H, K)
    params, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(1))
    pipe = TokenPipeline(PipelineConfig(vocab=j_cfg.vocab, seq_len=SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    batch = make_lm_batch(pipe.batch(0), frontend=j_cfg.frontend,
                          d_model=j_cfg.d_model,
                          mrope=j_cfg.rope == "mrope", seed=0)
    step = j_make_train_step(j_cfg, j_adamw.AdamWConfig(), n_micro=N_MICRO,
                             donate=False).step
    _, s, m = step(params, j_adamw.adamw_init(params),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    m = _host(m)
    scale = min(1.0, DEFAULT.grad_clip / max(float(m["grad_norm"]), 1e-9))
    grads = jax.tree.map(lambda x: x / ((1 - DEFAULT.b1) * scale),
                         _host(s.m))
    return dict(params_np=_host(params), batch=batch, metrics=m,
                grads=grads)


def _port_gradient(t_cfg, mesh, params, batch):
    """The train step's gradient (from its parameter delta under the
    linearising AdamW: ``g = d / (1 - |d|)``) and metrics: on ``mesh``,
    or one device without."""
    kw = (dict(mesh=mesh, param_specs=lm_param_specs(t_cfg),
               params_shape=params) if mesh is not None else {})
    fns = make_train_step(t_cfg, LINEAR, n_micro=N_MICRO, donate=False, **kw)
    new, _, metrics = fns.step(params, adamw_init(params), batch)
    if mesh is not None:
        new = gather(new)
    delta = [p - q for p, q in zip(tree_leaves(params), tree_leaves(new))]
    return tree_unflatten(tree_flatten(params)[1],
                          [d / (1 - d.abs()) for d in delta]), metrics


def _train_check(meshes, name, H, K, shape, **changes):
    ref = _reference(name, H, K)
    _, t_cfg = _configs(name, H, K)
    t_cfg = dataclasses.replace(t_cfg, **changes)
    params = lm_params_from_jax(ref["params_np"], t_cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    grads, metrics = _port_gradient(t_cfg, meshes[shape], params, batch)
    for k in ("loss", "xent", "accuracy", "tokens"):
        assert _nerr(metrics[k], ref["metrics"][k]) <= TRAIN_TOL, k
    tol = NOISY.get(name, (None, TRAIN_TOL))[1]
    got = jax.tree_util.tree_leaves_with_path(lm_params_to_jax(grads, t_cfg))
    want = jax.tree.leaves(ref["grads"])
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        assert a.shape == b.shape
        assert _nerr(a, b) <= tol, jax.tree_util.keystr(path)
    if name in NOISY:
        one, _ = _port_gradient(t_cfg, None, params, batch)
        for a, b in zip(tree_leaves(grads), tree_leaves(one)):
            assert _nerr(a, b) <= TRAIN_TOL


@pytest.mark.parametrize("seq_shard", [False, True],
                         ids=["whole-carry", "seq-shard-carry"])
@pytest.mark.parametrize("name,H,K,shape", CASES, ids=IDS)
def test_mesh_train_step_matches_reference(meshes, name, H, K, shape,
                                           seq_shard):
    """One sharded train step (remat ``"full"``, two micro-batches): the
    loss, the metrics and every leaf's gradient against the reference's
    single-device step, the carry whole or split over the sequence."""
    _train_check(meshes, name, H, K, shape, seq_shard_carry=seq_shard)


@pytest.mark.parametrize("seq_shard", [False, True],
                         ids=["whole-carry", "seq-shard-carry"])
def test_remat_dots_matches_reference(meshes, seq_shard):
    """The ``"dots"`` policy re-issues each period's collectives in its
    backward too; qwen2-vl-2b's case, both carries."""
    _train_check(meshes, *CASES[1], seq_shard_carry=seq_shard,
                 remat="dots")


# ---------------------------------------------------------------------------
# what still raises, and what no longer does


def test_split_still_raises_for_a_d_ff_the_model_axis_does_not_divide():
    """`_split` still refuses a ``d_ff`` that must split and does not;
    the mesh path no longer asks it to: where the model axis does not
    divide ``d_ff`` the pruned specs keep it whole and every model rank
    computes the FFN whole (`nn/tensor_parallel.py:_dense_ffn`), so a
    dry-run trace of such a mesh step (``d_ff`` 130 on (1, 4), its 3
    heads replicated) traces, with collective bytes, as the same config
    with a dividing ``d_ff`` does, and each rank does more FLOPs than
    there (its FFN is whole)."""
    with pytest.raises(ValueError, match="d_ff 130 does not split over the "
                                         "model axis"):
        _split(130, 4, "d_ff")
    assert _split(128, 4, "d_ff") == 32
    kw = dict(use_reduced=True, verbose=False,
              shape_override=t_configs.ShapeDef("tiny", "prefill", 16, 2))
    heads = {"n_heads": 3, "n_kv": 1, "dtype": torch.float32}
    reps = {d_ff: dryrun_lib.run_cell(
        "h2o-danube-1.8b", "prefill_32k", (1, 4), "t",
        config_overrides=dict(heads, d_ff=d_ff), **kw) for d_ff in (128, 130)}
    for rep in reps.values():
        assert rep["collectives"]["total_bytes"] > 0
    assert reps[130]["cost"]["flops"] > reps[128]["cost"]["flops"]


def test_an_expert_count_the_model_axis_does_not_divide_is_refused_by_both():
    """The experts are not replicated: a model axis that does not divide
    them is refused by the port (`nn/moe.py`, before any rank runs) and
    by the reference alike (`src/repro/nn/moe.py:139` asserts ``E % tp
    == 0``), on a mesh with a model axis of 3 and 4 experts."""
    import types

    from repro.nn import moe as j_moe
    from repro_torch.nn import moe as t_moe
    from repro_torch.nn.layers import Initializer
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 3})
    j_cfg = j_configs.get_arch("olmoe-1b-7b").reduced()
    t_cfg = t_configs.get_arch("olmoe-1b-7b").reduced()
    j_mp = dataclasses.replace(j_cfg.moe, n_experts=4, topk=2)
    t_mp = dataclasses.replace(t_cfg.moe, n_experts=4, topk=2)
    p = t_moe.moe_init(Initializer(torch.Generator().manual_seed(0),
                                   device="cpu"), t_cfg.d_model, t_mp)
    with pytest.raises(ValueError, match="4 experts do not split over "
                                         "model"):
        t_moe.moe_apply(p, torch.zeros(1, 2, t_cfg.d_model), t_mp,
                        mesh=mesh)
    with pytest.raises(AssertionError, match=r"\(4, 3\)"):
        j_moe.moe_apply({}, jnp.zeros((1, 2, j_cfg.d_model)), j_mp,
                        mesh=mesh)
