"""The FFN, the Mamba mixer and the vocabulary replicated over ``model`` on
gloo ranks on the CPU: the ``mesh=`` paths of `repro_torch.models.lm`
where the model axis does not divide ``d_ff``, ``d_inner`` or V
(`repro_torch.nn.tensor_parallel._whole`: the pruned specs keep no
``model`` axis on that dim, so every model rank computes that part
whole, as GSPMD runs the reference), held against the reference's
single-device results on carried weights (`lm_params_from_jax`) and
numpy-made inputs.

Cases, dims set with `dataclasses.replace` on both packages' reduced
configs:

  * falcon-mamba-7b on (1, 3): d_inner 128 and V 256 both whole (as
    Falcon-Mamba-7B's 8192 and 65024 on a model axis of 3);
  * qwen2-vl-2b with H 6 / K 2 on (1, 3): the query heads split, d_ff
    128 and V 256 whole (as its 8960 and 151936 on 3), an ``embeds``
    frontend;
  * gemma2-2b with d_ff 192 on (1, 3): d_ff split, V 256 whole and tied,
    its 4 heads replicated: a mixed case;
  * h2o-danube-1.8b on (2, 3): V 256 and d_ff 128 whole, the batch split
    over ``data`` as well.

Checked: prefill's last-token logits and ``kvs`` and 8 decode steps from
step 0 against `repro.nn.transformer.lm_prefill` / `lm_decode_step`; one
train step's loss and gradients against the reference's
`make_train_step`, with ``seq_shard_carry`` off and on (S 96, a multiple
of 3), under remat ``"full"`` and ``"dots"``: the backward must count
each rank's contribution once, neither summing a whole gradient over
``model`` nor leaving a partial one unsummed; and two steps on (2, 2),
where everything splits, moved by `remesh_state` onto (1, 3), where it
does not, then two more, against four steps on (2, 2).

Tolerances in ``max|a-b| / (1 + max|b|)``, float32, those of
`tests/test_torch_lm_mesh_heads.py`: serving 1e-5, training 1e-4, and
gemma2-2b 1e-4 / 1e-3 (its random weights amplify rounding past the
tighter limits on one device too); the re-meshed trajectory 1e-5."""
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
from repro_torch.distributed.ranks import close_groups
from repro_torch.distributed.sharding import (tree_flatten, tree_leaves,
                                              tree_unflatten)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import (lm_params_from_jax, lm_params_to_jax,
                                   make_decode_step, make_prefill_step,
                                   make_train_step)
from repro_torch.nn.transformer import init_lm_cache, lm_param_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.elastic import gather, remesh_state, reshard

BATCH, SEQ, DECODE_STEPS, CACHE_SEQ = 2, 96, 8, 9
TRAIN_BATCH, N_MICRO = 4, 2
TOL = 1e-5
TRAIN_TOL = 1e-4
TRAJECTORY_TOL = 1e-5
NOISY = {"gemma2-2b": (1e-4, 1e-3)}      # (serving, training vs reference)
LINEAR = AdamWConfig(lr=1.0, eps=1.0, weight_decay=0.0, grad_clip=None)
DEFAULT = AdamWConfig()
# (arch, config changes, mesh, whole over model: of "heads", "d_ff",
#  "d_inner", "vocab", those the arch has)
CASES = [
    ("falcon-mamba-7b", (), (1, 3), {"d_inner": True, "vocab": True}),
    ("qwen2-vl-2b", (("n_heads", 6), ("n_kv", 2)), (1, 3),
     {"heads": False, "d_ff": True, "vocab": True}),
    ("gemma2-2b", (("d_ff", 192),), (1, 3),
     {"heads": True, "d_ff": False, "vocab": True}),
    ("h2o-danube-1.8b", (), (2, 3),
     {"heads": True, "d_ff": True, "vocab": True}),
]
IDS = [c[0] for c in CASES]


def _nerr(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().float() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


@pytest.fixture(scope="module")
def meshes():
    yield {shape: make_mesh(shape, ("data", "model"), device="cpu")
           for shape in ((1, 3), (2, 3), (2, 2))}
    close_groups()


def _configs(name: str, changes: tuple):
    return (dataclasses.replace(j_configs.get_arch(name).reduced(),
                                **dict(changes)),
            dataclasses.replace(t_configs.get_arch(name).reduced(),
                                **dict(changes)))


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


def _model_on(entry) -> bool:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return "model" in axes


def _assert_layout(pspecs, t_cfg, whole: dict):
    """The pruned specs split over ``model`` exactly what the case says:
    heads (``wq`` dim 1), ``d_ff`` (``wi`` dim 2), ``d_inner``
    (``in_proj`` dim 2), the vocabulary (``embed`` dim 0 or ``unembed``
    dim 1)."""
    vocab = (pspecs["embed"][0] if "unembed" not in pspecs
             else pspecs["unembed"][1])
    assert _model_on(vocab) != whole["vocab"]
    for slots in pspecs["blocks"]:
        for spec, sp in zip(t_cfg.period, slots):
            if spec.kind == "attn":
                assert _model_on(sp["attn"]["wq"][1]) != whole["heads"]
            else:
                assert _model_on(sp["mamba"]["in_proj"][2]) != \
                    whole["d_inner"]
            if spec.mlp == "glu":
                assert _model_on(sp["ffn"]["wi"][2]) != whole["d_ff"]


@pytest.mark.parametrize("name,changes,shape,whole", CASES, ids=IDS)
def test_mesh_prefill_and_decode_match_reference(meshes, name, changes,
                                                 shape, whole):
    """`make_prefill_step(mesh=)`: last-token logits and the gathered kvs
    against the reference's single-device `lm_prefill`;
    `make_decode_step(mesh=)`: every step's logits from step 0 and the
    gathered cache after the last (Mamba's conv and SSM states whole on
    every model rank) against `lm_decode_step`."""
    mesh = meshes[shape]
    tol = NOISY.get(name, (TOL,))[0]
    j_cfg, t_cfg = _configs(name, changes)
    jp, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), t_cfg,
                                device="cpu")
    inputs, pos = _inputs(j_cfg, seed=2)
    want, j_kvs = jax.jit(lambda p, i, q: j_tf.lm_prefill(p, j_cfg, i, q))(
        jp, _jnp(inputs), jnp.asarray(pos))

    specs = lm_param_specs(t_cfg)
    prefill, _ = make_prefill_step(t_cfg, mesh=mesh, param_specs=specs,
                                   params_shape=params, backend="torch")
    _assert_layout(prefill.pspecs, t_cfg, whole)
    handle = reshard(params, mesh, prefill.pspecs)
    got, kvs = prefill(handle, torch.from_numpy(inputs),
                       torch.from_numpy(pos))
    assert got.shape == (BATCH, t_cfg.vocab) and got.dtype == torch.float32
    assert _nerr(got, want) <= tol
    for t_kv, j_kv in zip(gather(kvs), j_kvs):
        if j_kv is None:
            assert t_kv is None
            continue
        for a, b in zip(t_kv, j_kv):
            assert tuple(a.shape) == b.shape
            assert _nerr(a, np.asarray(b)) <= tol

    j_cache = j_tf.init_lm_cache(j_cfg, BATCH, max_seq=CACHE_SEQ,
                                 dtype=jnp.float32)
    cache = init_lm_cache(t_cfg, BATCH, max_seq=CACHE_SEQ,
                          dtype=torch.float32, device="cpu")
    decode, _, _ = make_decode_step(t_cfg, mesh=mesh, param_specs=specs,
                                    params_shape=params, cache_shape=cache)
    if whole.get("d_inner"):
        assert all(not _model_on(e) for sp in tree_leaves(decode.cspecs)
                   for e in sp)
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


def _batch(j_cfg) -> dict:
    pipe = TokenPipeline(PipelineConfig(vocab=j_cfg.vocab, seq_len=SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    return make_lm_batch(pipe.batch(0), frontend=j_cfg.frontend,
                         d_model=j_cfg.d_model, mrope=j_cfg.rope == "mrope",
                         seed=0)


@functools.lru_cache(maxsize=None)
def _reference(name: str, changes: tuple):
    """The reference's weights, batch, one default step's metrics and its
    gradient (from the first moment: ``m = (1 - b1) g s``, ``s`` the
    clipping scale at its ``grad_norm``); one compile per case."""
    j_cfg, _ = _configs(name, changes)
    params, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(1))
    batch = _batch(j_cfg)
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


def _train_check(meshes, name, changes, shape, **cfg_changes):
    ref = _reference(name, changes)
    _, t_cfg = _configs(name, changes)
    t_cfg = dataclasses.replace(t_cfg, **cfg_changes)
    params = lm_params_from_jax(ref["params_np"], t_cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    grads, metrics = _port_gradient(t_cfg, meshes[shape], params, batch)
    for k in ("loss", "xent", "accuracy", "tokens", "grad_norm"):
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
@pytest.mark.parametrize("name,changes,shape,whole", CASES, ids=IDS)
def test_mesh_train_step_matches_reference(meshes, name, changes, shape,
                                           whole, seq_shard):
    """One sharded train step (remat ``"full"``, two micro-batches): the
    loss, the metrics, the gradient norm and every leaf's gradient
    against the reference's single-device step, the carry whole or split
    over the sequence."""
    _train_check(meshes, name, changes, shape, seq_shard_carry=seq_shard)


@pytest.mark.parametrize("name,changes,shape,whole", CASES[:2],
                         ids=IDS[:2])
def test_remat_dots_matches_reference(meshes, name, changes, shape, whole):
    """The ``"dots"`` policy re-issues each period's collectives in its
    backward too: the whole Mamba mixer and the whole FFN and vocabulary,
    on a sequence-split carry."""
    _train_check(meshes, name, changes, shape, seq_shard_carry=True,
                 remat="dots")


@pytest.mark.parametrize("name,changes", [c[:2] for c in CASES[:2]],
                         ids=IDS[:2])
def test_remesh_from_split_to_whole_keeps_the_trajectory(meshes, name,
                                                         changes):
    """Two steps on (2, 2), where ``d_inner`` / ``d_ff``, the vocabulary
    and the heads all split over ``model``, the live parameters and
    `OptState` moved by `remesh_state` onto (1, 3), where they do not
    (the heads of qwen2-vl-2b's case still do), two more steps there:
    the losses are the four-step (2, 2) run's within 1e-5, and fall."""
    j_cfg, t_cfg = _configs(name, changes)
    jp, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(1))
    params = lm_params_from_jax(_host(jp), t_cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(j_cfg).items()}
    specs = lm_param_specs(t_cfg)

    def step_on(shape):
        return make_train_step(t_cfg, DEFAULT, mesh=meshes[shape],
                               n_micro=N_MICRO, param_specs=specs,
                               params_shape=params).step

    runs = []
    for remesh in (False, True):
        step = step_on((2, 2))
        hp = reshard(params, meshes[(2, 2)], step.pspecs)
        ho = reshard(adamw_init(params), meshes[(2, 2)], step.ospecs)
        losses = []
        for i in range(4):
            if remesh and i == 2:
                step = step_on((1, 3))
                _assert_layout(step.pspecs, t_cfg, CASES[IDS.index(name)][3])
                hp = remesh_state(hp, step.pspecs, meshes[(1, 3)])
                ho = remesh_state(ho, step.ospecs, meshes[(1, 3)])
                assert hp.mesh is meshes[(1, 3)]
            hp, ho, m = step(hp, ho, batch)
            losses.append(float(m["loss"]))
        hp.drop()
        ho.drop()
        runs.append(losses)
    assert max(abs(a - b) for a, b in zip(*runs)) <= TRAJECTORY_TOL
    assert runs[1][-1] < runs[1][0]
