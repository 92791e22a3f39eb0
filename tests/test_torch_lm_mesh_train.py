"""The sharded LM train step on gloo ranks on the CPU:
`repro_torch.models.lm.make_train_step(mesh=)` (the differentiable
collectives of `repro_torch.distributed.ranks`, the backward of
`repro_torch.nn.tensor_parallel`, the vocab-parallel cross-entropy, the
rank-side micro-batching of `repro_torch.distributed.accumulate`, the
sharded AdamW with the whole gradient's norm) held against the
reference's single-device `repro.models.lm.make_train_step` on carried
weights (`lm_params_from_jax`) and numpy-made batches (`TokenPipeline`
step 0 at B 4, S 32, two micro-batches).

One pooled group of 4 ranks carries every mesh here, (2, 2) and (1, 4)
alike.  MoE configs run at a capacity factor of ``n_experts / topk``: no
choice drops, so a per-rank capacity (the mesh rule) and the reference's
whole-batch one agree.

What is compared, in ``max|a-b| / (1 + max|b|)`` per leaf, float32:

  * the gradient: the port's from its parameter delta under the
    linearising ``AdamWConfig(lr=1, eps=1, weight_decay=0,
    grad_clip=None)`` (the first step moves a parameter by ``g / (|g| +
    1)``, so ``g = d / (1 - |d|)``); the reference's from its first
    moment after one default step (``m = (1 - b1) g s``, ``s`` the
    clipping scale at its ``grad_norm``), which spares a second compile
    of the reference's step per architecture;
  * the loss, the metrics and ``grad_norm`` of both default steps, and
    the gathered parameters, ``m`` and ``v`` after them.  Adam's first
    step is about ``sign(g) lr``: where the reference's gradient lies
    within the cell's gradient tolerance of zero the sign is noise, so a
    parameter may differ there by up to ``2 lr`` (as in
    `tests/test_torch_lm_train.py`).

Limits: 1e-4.  gemma2-2b and jamba are held to the reference at 1e-3
and to the one-device port (`make_train_step` without a mesh, on the
same weights and batch) at 1e-4: in both cells the one-device port's
own gradient differs from the reference's by more than 1e-4 (gemma2-2b:
the noise floor the one-device port measured; jamba at S 32: about
1.2e-4, checked in `test_sharded_step_matches_reference`), and the mesh
adds less than 1e-4 to that.  A re-mesh keeps the loss trajectory
within 1e-5 of the un-re-meshed run's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.data import PipelineConfig, TokenPipeline, make_lm_batch
from repro.models.lm import _batch_specs as j_batch_specs
from repro.models.lm import make_train_step as j_make_train_step
from repro.nn import transformer as j_tf
from repro.optim import adamw as j_adamw

from repro_torch import configs as t_configs
from repro_torch.distributed.sharding import (P, tree_flatten, tree_leaves,
                                              tree_map, tree_unflatten)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import (LMModel, lm_params_from_jax,
                                   lm_params_to_jax, make_train_step,
                                   opt_state_specs)
from repro_torch.nn.transformer import lm_param_specs
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init
from repro_torch.runtime.elastic import gather, remesh_state, reshard

BATCH, SEQ, N_MICRO = 4, 32, 2
TOL = 1e-4
NOISY = {"gemma2-2b": 1e-3, "jamba-v0.1-52b": 1e-3}
TRAJECTORY_TOL = 1e-5
LINEAR = AdamWConfig(lr=1.0, eps=1.0, weight_decay=0.0, grad_clip=None)
DEFAULT = AdamWConfig()
CELLS = [("h2o-danube-1.8b", (2, 2)), ("jamba-v0.1-52b", (2, 2)),
         ("gemma2-2b", (1, 4)), ("olmoe-1b-7b", (2, 2)),
         ("starcoder2-15b", (1, 4))]


def _nerr(a, b) -> float:
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


@pytest.fixture(scope="module")
def meshes():
    return {(2, 2): make_mesh((2, 2), ("data", "model"), device="cpu"),
            (1, 4): make_mesh((1, 4), ("data", "model"), device="cpu")}


def _configs(name: str):
    j_cfg = j_configs.get_arch(name).reduced()
    t_cfg = t_configs.get_arch(name).reduced()
    if j_cfg.moe is not None:
        cf = j_cfg.moe.n_experts / j_cfg.moe.topk
        j_cfg = dataclasses.replace(j_cfg, moe=dataclasses.replace(
            j_cfg.moe, capacity_factor=cf))
        t_cfg = dataclasses.replace(t_cfg, moe=dataclasses.replace(
            t_cfg.moe, capacity_factor=cf))
    return j_cfg, t_cfg


def _batch(cfg, mask_seed=None) -> dict:
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                        global_batch=BATCH, seed=0))
    batch = make_lm_batch(pipe.batch(0), frontend=cfg.frontend,
                          d_model=cfg.d_model, mrope=cfg.rope == "mrope",
                          seed=0)
    if mask_seed is not None:
        # unequal counts per row, so per rank and per micro-batch
        rng = np.random.default_rng(mask_seed)
        keep = rng.uniform(size=(BATCH, 1)) * rng.uniform(size=(BATCH, SEQ))
        batch["mask"] = (keep > 0.15).astype(np.float32)
    return batch


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference_step(name: str, mask_seed=None):
    """The reference's weights, batch and jitted default step (one
    compile per cell)."""
    j_cfg, _ = _configs(name)
    params, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(1))
    batch = _batch(j_cfg, mask_seed)
    step = j_make_train_step(j_cfg, j_adamw.AdamWConfig(), n_micro=N_MICRO,
                             donate=False).step
    return params, batch, step


@functools.lru_cache(maxsize=None)
def _reference(name: str, mask_seed=None, steps: int = 2):
    """``steps`` default reference steps: each step's metrics, the
    gradient (from the first moment after one step), and the parameters
    and moments after the last."""
    params, batch, step = _reference_step(name, mask_seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, s = params, j_adamw.adamw_init(params)
    metrics, m1 = [], None
    for _ in range(steps):
        p, s, m = step(p, s, jb)
        metrics.append(_host(m))
        if m1 is None:
            m1 = _host(s.m)
    gn = float(metrics[0]["grad_norm"])
    scale = min(1.0, DEFAULT.grad_clip / max(gn, 1e-9))
    grads = jax.tree.map(lambda m: m / ((1 - DEFAULT.b1) * scale), m1)
    return dict(params_np=_host(params), batch=batch, metrics=metrics,
                grads=grads, new_params=_host(p), m=_host(s.m),
                v=_host(s.v))


def _pairs(port_tree, ref_tree, cfg):
    got = jax.tree_util.tree_leaves_with_path(lm_params_to_jax(port_tree,
                                                               cfg))
    want = jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    return [(jax.tree_util.keystr(p), a, b) for (p, a), b in zip(got, want)]


def _port_inputs(name, ref, **changes):
    _, t_cfg = _configs(name)
    t_cfg = dataclasses.replace(t_cfg, **changes)
    params = lm_params_from_jax(ref["params_np"], t_cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    return t_cfg, params, batch


def _mesh_kw(t_cfg, mesh, params) -> dict:
    return dict(mesh=mesh, n_micro=N_MICRO, param_specs=lm_param_specs(t_cfg),
                params_shape=params)


def _port_gradient(t_cfg, mesh, params, batch):
    """The train step's gradient (from its parameter delta under the
    linearising AdamW) and metrics: on ``mesh``, or one device without."""
    kw = _mesh_kw(t_cfg, mesh, params) if mesh is not None else {
        "n_micro": N_MICRO}
    fns = make_train_step(t_cfg, LINEAR, donate=False, **kw)
    new, _, metrics = fns.step(params, adamw_init(params), batch)
    if mesh is not None:
        new = gather(new)
    delta = [p - q for p, q in zip(tree_leaves(params), tree_leaves(new))]
    grads = tree_unflatten(tree_flatten(params)[1],
                           [d / (1 - d.abs()) for d in delta])
    return grads, metrics


def _check_gradient(grads, ref, t_cfg, tol):
    for path, a, b in _pairs(grads, ref["grads"], t_cfg):
        assert a.shape == b.shape and _nerr(a, b) <= tol, path


def _check_metrics(metrics, want, tol):
    for k in ("loss", "xent", "accuracy", "tokens", "aux_loss"):
        assert _nerr(metrics[k], want[k]) <= TOL, k
    assert _nerr(metrics["grad_norm"], want["grad_norm"]) <= tol
    assert _nerr(metrics["lr"], want["lr"]) == 0.0


def _check_state(params, opt_state, ref, t_cfg, tol):
    """Parameters, moments and the step counter after the reference's
    default steps."""
    assert int(opt_state.step) == len(ref["metrics"])
    for tree, want in ((opt_state.m, ref["m"]), (opt_state.v, ref["v"])):
        for path, a, b in _pairs(tree, want, t_cfg):
            assert _nerr(a, b) <= tol, path
    grads = jax.tree.leaves(ref["grads"])
    for (path, a, b), g in zip(_pairs(params, ref["new_params"], t_cfg),
                               grads):
        diff = np.abs(a.astype(np.float64) - b)
        near_zero = np.abs(g) <= tol * (1.0 + np.abs(g).max())
        limit = tol * (1.0 + np.abs(b).max())
        assert (diff[~near_zero] <= limit).all(), path
        assert (diff[near_zero] <= 2 * DEFAULT.lr + limit).all(), path


def _default_steps(t_cfg, mesh, params, batch, steps=2):
    """``steps`` donated default steps from handles; returns (gathered
    parameters, gathered `OptState`, each step's metrics)."""
    fns = make_train_step(t_cfg, DEFAULT, donate=True,
                          **_mesh_kw(t_cfg, mesh, params))
    hp = reshard(params, mesh, fns.step.pspecs)
    ho = reshard(adamw_init(params), mesh, fns.step.ospecs)
    metrics = []
    for _ in range(steps):
        out_p, out_o, m = fns.step(hp, ho, batch)
        assert out_p is hp and out_o is ho
        metrics.append(m)
    return gather(hp), gather(ho), metrics


@pytest.mark.parametrize("name,shape", CELLS)
def test_sharded_step_matches_reference(meshes, name, shape):
    """Loss, metrics, ``grad_norm`` and the gradient of the sharded step,
    then the gathered parameters, ``m`` and ``v`` after two default
    steps, against the reference's single-device step."""
    tol = NOISY.get(name, TOL)
    ref = _reference(name)
    t_cfg, params, batch = _port_inputs(name, ref)
    grads, lin = _port_gradient(t_cfg, meshes[shape], params, batch)
    _check_gradient(grads, ref, t_cfg, tol)
    for k in ("loss", "xent", "accuracy", "tokens", "aux_loss"):
        assert _nerr(lin[k], ref["metrics"][0][k]) <= TOL, k
    if name in NOISY:
        one, _ = _port_gradient(t_cfg, None, params, batch)
        gap = max(_nerr(a, b) for _, a, b in _pairs(one, ref["grads"],
                                                     t_cfg))
        assert gap > TOL, f"the one-device port's own gap {gap:.2e}"
        for a, b in zip(tree_leaves(grads), tree_leaves(one)):
            assert _nerr(a, b) <= TOL
    new_p, new_o, metrics = _default_steps(t_cfg, meshes[shape], params,
                                           batch)
    for got, want in zip(metrics, ref["metrics"]):
        _check_metrics(got, want, tol)
    _check_state(new_p, new_o, ref, t_cfg, tol)


def test_mask_with_unequal_counts_matches(meshes):
    """A random mask whose counts differ by row (so by rank and by
    micro-batch): the cross-entropy of each micro-batch is over its whole
    mask count, the metrics are the whole batch's."""
    name = "h2o-danube-1.8b"
    ref = _reference(name, mask_seed=3)
    mask = ref["batch"]["mask"]
    per_rank = mask.reshape(N_MICRO, 2, -1).sum(-1)
    assert len(np.unique(per_rank)) == per_rank.size
    t_cfg, params, batch = _port_inputs(name, ref)
    grads, lin = _port_gradient(t_cfg, meshes[(2, 2)], params, batch)
    _check_gradient(grads, ref, t_cfg, TOL)
    assert _nerr(lin["tokens"], ref["metrics"][0]["tokens"]) == 0.0
    new_p, new_o, metrics = _default_steps(t_cfg, meshes[(2, 2)], params,
                                           batch)
    for got, want in zip(metrics, ref["metrics"]):
        _check_metrics(got, want, TOL)
    _check_state(new_p, new_o, ref, t_cfg, TOL)


def test_micro_batch_held_whole_by_every_batch_rank_matches(meshes):
    """Micro-batches of 2 rows on a (4, 1) mesh do not split over
    ``data``: every data rank holds its micro-batch whole (the
    reference's constraint falls back to that) and the step counts it
    once, not 4 times."""
    name = "h2o-danube-1.8b"
    ref = _reference(name)
    t_cfg, params, batch = _port_inputs(name, ref)
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    grads, metrics = _port_gradient(t_cfg, mesh, params, batch)
    _check_gradient(grads, ref, t_cfg, TOL)
    for k in ("loss", "xent", "accuracy", "tokens"):
        assert _nerr(metrics[k], ref["metrics"][0][k]) <= TOL, k


def test_pod_axis_matches(meshes):
    """A (2, 1, 2) mesh over (pod, data, model), the reference's
    multi-pod layout: the batch splits over pod, the gradients of every
    leaf are summed over it."""
    name = "h2o-danube-1.8b"
    ref = _reference(name)
    t_cfg, params, batch = _port_inputs(name, ref)
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    grads, metrics = _port_gradient(t_cfg, mesh, params, batch)
    _check_gradient(grads, ref, t_cfg, TOL)
    _check_metrics(metrics, dict(ref["metrics"][0], lr=1.0), TOL)


def test_clipping_is_active_and_grad_norm_is_the_whole_gradients(meshes):
    """The default clip (1.0) is active (the norm is above it) and the
    sharded step's ``grad_norm`` is the reference's: each distinct shard
    counted once, not once per rank that holds it."""
    name = "starcoder2-15b"
    ref = _reference(name)
    assert float(ref["metrics"][0]["grad_norm"]) > DEFAULT.grad_clip
    t_cfg, params, batch = _port_inputs(name, ref)
    for shape in ((1, 4), (2, 2)):
        _, _, metrics = _default_steps(t_cfg, meshes[shape], params, batch,
                                       steps=1)
        assert _nerr(metrics[0]["grad_norm"],
                     ref["metrics"][0]["grad_norm"]) <= TOL, shape


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_match(meshes, remat):
    """Both remat policies recompute each period's forward, collectives
    included, in the backward; the gradient is the reference's."""
    name = "olmoe-1b-7b"
    ref = _reference(name)
    t_cfg, params, batch = _port_inputs(name, ref, remat=remat)
    grads, _ = _port_gradient(t_cfg, meshes[(2, 2)], params, batch)
    _check_gradient(grads, ref, t_cfg, TOL)


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "starcoder2-15b"])
def test_seq_shard_carry_matches(meshes, name):
    """The residual held split over the sequence on ``model`` (a
    reduce-scatter ends each row-parallel layer, an all-gather comes
    before the next column-parallel one): the reference's gradient, and
    the same step without it within float32 rounding."""
    ref = _reference(name)
    t_cfg, params, batch = _port_inputs(name, ref, seq_shard_carry=True)
    grads, metrics = _port_gradient(t_cfg, meshes[(1, 4)], params, batch)
    _check_gradient(grads, ref, t_cfg, TOL)
    plain_cfg = dataclasses.replace(t_cfg, seq_shard_carry=False)
    plain, plain_metrics = _port_gradient(plain_cfg, meshes[(1, 4)], params,
                                          batch)
    assert _nerr(metrics["loss"], plain_metrics["loss"]) <= TRAJECTORY_TOL
    for a, b in zip(tree_leaves(grads), tree_leaves(plain)):
        assert _nerr(a, b) <= TRAJECTORY_TOL


def test_remesh_mid_training_keeps_the_trajectory(meshes):
    """Two steps on (2, 2), the live parameters and `OptState` moved to
    (1, 4) by `remesh_state`, two more steps there: the losses are the
    four-step (2, 2) run's, and the reference's."""
    name = "h2o-danube-1.8b"
    ref = _reference(name, steps=4)
    t_cfg, params, batch = _port_inputs(name, ref)
    kw = _mesh_kw(t_cfg, meshes[(2, 2)], params)
    runs = []
    for remesh in (False, True):
        fns = make_train_step(t_cfg, DEFAULT, donate=True, **kw)
        hp = reshard(params, meshes[(2, 2)], fns.step.pspecs)
        ho = reshard(adamw_init(params), meshes[(2, 2)], fns.step.ospecs)
        losses = []
        for i in range(4):
            if remesh and i == 2:
                fns = make_train_step(t_cfg, DEFAULT, donate=True,
                                      **_mesh_kw(t_cfg, meshes[(1, 4)],
                                                 params))
                hp = remesh_state(hp, fns.step.pspecs, meshes[(1, 4)])
                ho = remesh_state(ho, fns.step.ospecs, meshes[(1, 4)])
                assert hp.mesh is meshes[(1, 4)]
            hp, ho, m = fns.step(hp, ho, batch)
            losses.append(float(m["loss"]))
        runs.append(losses)
    want = [float(m["loss"]) for m in ref["metrics"]]
    assert max(abs(a - b) for a, b in zip(runs[1], runs[0])) \
        <= TRAJECTORY_TOL
    assert max(_nerr(a, b) for a, b in zip(runs[1], want)) <= TOL
    assert runs[0][-1] < runs[0][0]


def test_batch_spec_is_the_references(meshes):
    """`TrainStepFns.batch_spec` and the shardings' specs equal the
    reference's `_batch_specs` on a one-device JAX mesh with the same
    axis names, for a token and an M-RoPE embeds frontend."""
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    for name in ("h2o-danube-1.8b", "qwen2-vl-2b"):
        j_cfg, t_cfg = _configs(name)
        meta = LMModel.create(t_cfg, device="meta").params
        fns = make_train_step(t_cfg, DEFAULT,
                              **_mesh_kw(t_cfg, meshes[(2, 2)], meta))
        want = j_batch_specs(j_cfg, jmesh)
        assert fns.batch_spec.keys() == want.keys()
        for k, spec in want.items():
            assert tuple(fns.batch_spec[k]) == tuple(spec), k
        p_shard, o_shard, b_shard = fns.in_shardings
        assert {k: s.spec for k, s in b_shard.items()} == fns.batch_spec
        assert isinstance(o_shard, OptState) and o_shard.step.spec == P()
        assert tree_leaves(o_shard.m) == tree_leaves(p_shard)
        assert fns.out_shardings[:2] == (p_shard, o_shard)


def test_tree_helpers_and_reshard_round_trip_an_opt_state(meshes):
    """`tree_map` rebuilds a NamedTuple by its fields (an `OptState`
    whole), and `reshard` / `gather` / `remesh_state` carry one bit for
    bit, its 0-d step included."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(8, 4, generator=g),
              "blocks": [({"g": torch.randn(4, generator=g)},)]}
    state = OptState(step=torch.tensor(7, dtype=torch.int32),
                     m=tree_map(lambda t: torch.randn(t.shape, generator=g),
                                params),
                     v=tree_map(lambda t: torch.rand(t.shape, generator=g),
                                params))
    doubled = tree_map(lambda t: t * 2, state)
    assert type(doubled) is OptState and int(doubled.step) == 14
    specs = opt_state_specs({"w": P("data", "model"),
                             "blocks": [({"g": P(None)},)]})
    for mesh in meshes.values():
        handle = reshard(state, mesh, specs)
        back = gather(handle)
        assert type(back) is OptState and back.step.shape == ()
        for a, b in zip(tree_leaves(back), tree_leaves(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        moved = gather(remesh_state(handle, specs, meshes[(1, 4)]))
        for a, b in zip(tree_leaves(moved), tree_leaves(state)):
            assert torch.equal(a, b)
