"""The LM serving mesh on gloo ranks on the CPU: `repro_torch.launch.mesh`,
the axis groups of `repro_torch.distributed.ranks`,
`repro_torch.runtime.elastic` and the ``mesh=`` paths of
`repro_torch.models.lm` (`repro_torch.nn.tensor_parallel`), held against
the reference's single-device results (`repro.nn.transformer`'s
`lm_prefill` / `lm_decode_step`) on carried weights (`lm_params_from_jax`)
and numpy-made inputs.

One pooled group of 4 ranks carries every mesh here, (2, 2) and (1, 4)
alike (`make_mesh` takes `shard_group`'s group).  The ranks run the
scan's plain version (CPU tensors).  MoE configs run at a capacity
factor of ``n_experts / topk``: no choice drops, so a per-rank capacity
(the mesh rule) and the reference's whole-batch one agree.

Tolerances, in ``max|a-b| / (1 + max|b|)``, float32: 1e-5 for the
prefill logits and decode; 1e-4 for gemma2-2b and jamba, whose random
weights amplify rounding past 1e-5 on one device too
(`tests/test_torch_lm_archs.py`, ``NOISY``).  Elastic round trips are
exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _shard_ranks
from repro import configs as j_configs
from repro.nn import transformer as j_tf

from repro_torch import configs as t_configs
from repro_torch.distributed.sharding import tree_leaves
from repro_torch.launch.mesh import make_mesh, set_mesh, current_mesh
from repro_torch.models.lm import (LMModel, lm_params_from_jax,
                                   make_decode_step, make_prefill_step)
from repro_torch.nn.layers import PartitionSpec as P
from repro_torch.nn.transformer import init_lm_cache, lm_param_specs
from repro_torch.runtime.elastic import gather, remesh_state, reshard

BATCH, SEQ, DECODE_STEPS = 2, 32, 8
TOL = 1e-5
NOISY_TOL = 1e-4
NOISY = {"gemma2-2b", "jamba-v0.1-52b"}


def _nerr(a, b) -> float:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


@pytest.fixture(scope="module")
def meshes():
    return {(2, 2): make_mesh((2, 2), ("data", "model"), device="cpu"),
            (1, 4): make_mesh((1, 4), ("data", "model"), device="cpu")}


def _configs(name: str):
    """Reduced configs; MoE at a drop-free capacity; the reference's Mamba
    slots on its Pallas scan in interpret mode."""
    j_cfg = j_configs.get_arch(name).reduced()
    t_cfg = t_configs.get_arch(name).reduced()
    if j_cfg.moe is not None:
        cf = j_cfg.moe.n_experts / j_cfg.moe.topk
        j_cfg = dataclasses.replace(j_cfg, moe=dataclasses.replace(
            j_cfg.moe, capacity_factor=cf))
        t_cfg = dataclasses.replace(t_cfg, moe=dataclasses.replace(
            t_cfg.moe, capacity_factor=cf))
    if j_cfg.mamba is not None:
        j_cfg = dataclasses.replace(j_cfg, mamba=dataclasses.replace(
            j_cfg.mamba, pallas_scan="interpret"))
    return j_cfg, t_cfg


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(SEQ, dtype=np.int32), (BATCH, SEQ)))
    return tokens, pos


def test_axis_groups_order_and_collectives(meshes):
    """Rank r sits at `np.unravel_index(r, shape)`; a collective over an
    axis runs among the ranks of that axis's slice, in their order along
    it; over both axes it is the whole group."""
    for shape, mesh in meshes.items():
        got = mesh.group.run(_shard_ranks.r_axis_collectives, None,
                             mesh.key)
        grid = np.arange(4).reshape(shape)
        for r, out in enumerate(got):
            d, m = np.unravel_index(r, shape)
            assert out["coords"] == {"data": d, "model": m}
            assert out[("data",)] == (float(grid[:, m].sum()),
                                      grid[:, m].astype(float).tolist(), d)
            assert out[("model",)] == (float(grid[d].sum()),
                                       grid[d].astype(float).tolist(), m)
            assert out[("data", "model")] == (6.0, [0.0, 1.0, 2.0, 3.0], r)
            assert out["max"] == float(grid[d].max())
    with set_mesh(meshes[(2, 2)]) as m:
        assert current_mesh() is m
    assert current_mesh() is None


@pytest.mark.parametrize("name,shape", [
    ("h2o-danube-1.8b", (2, 2)), ("jamba-v0.1-52b", (2, 2)),
    ("gemma2-2b", (1, 4)), ("olmoe-1b-7b", (2, 2))])
def test_mesh_prefill_and_decode_match_reference(meshes, name, shape):
    """`make_prefill_step(mesh=)`: last-token logits and the gathered kvs
    against the reference's single-device `lm_prefill`;
    `make_decode_step(mesh=)`: every step's logits from step 0 and the
    gathered cache after the last against `lm_decode_step`.  gemma2-2b
    (2 kv heads) on (1, 4) splits its cache by sequence, so its decode
    combines per-shard partials; the others split kv heads."""
    mesh = meshes[shape]
    tol = NOISY_TOL if name in NOISY else TOL
    j_cfg, t_cfg = _configs(name)
    jp, _ = j_tf.lm_init(j_cfg, jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), t_cfg,
                                device="cpu")
    tokens, pos = _inputs(j_cfg, seed=2)
    want, j_kvs = jax.jit(lambda p, i, q: j_tf.lm_prefill(p, j_cfg, i, q))(
        jp, jnp.asarray(tokens), jnp.asarray(pos))

    specs = lm_param_specs(t_cfg)
    prefill, p_shard = make_prefill_step(t_cfg, mesh=mesh, param_specs=specs,
                                         params_shape=params,
                                         backend="torch")
    assert tree_leaves(p_shard)[0].mesh is mesh
    handle = reshard(params, mesh, prefill.pspecs)
    got, kvs = prefill(handle, torch.from_numpy(tokens),
                       torch.from_numpy(pos))
    assert got.shape == (BATCH, t_cfg.vocab) and got.dtype == torch.float32
    assert _nerr(got, want) <= TOL
    whole = gather(kvs)
    for spec, t_kv, j_kv in zip(t_cfg.period, whole, j_kvs):
        assert (t_kv is None) == (spec.kind != "attn")
        if t_kv is not None:
            for a, b in zip(t_kv, j_kv):
                assert tuple(a.shape) == b.shape
                assert _nerr(a, np.asarray(b)) <= tol
    kv_spec = tuple(kvs.specs[[s.kind for s in t_cfg.period].index("attn")][0])
    assert kv_spec == ((None, "data", "model", None, None) if shape == (1, 4)
                       else (None, "data", None, "model", None))

    j_cache = j_tf.init_lm_cache(j_cfg, BATCH, max_seq=DECODE_STEPS,
                                 dtype=jnp.float32)
    cache = init_lm_cache(t_cfg, BATCH, max_seq=DECODE_STEPS,
                          dtype=torch.float32, device="cpu")
    decode, _, c_shard = make_decode_step(
        t_cfg, mesh=mesh, param_specs=specs, params_shape=params,
        cache_shape=cache)
    j_step = jax.jit(lambda p, c, tok, t: j_tf.lm_decode_step(
        p, j_cfg, c, tok, t))
    for t in range(DECODE_STEPS):
        want, j_cache = j_step(jp, j_cache, jnp.asarray(tokens[:, t]),
                               jnp.int32(t))
        got, cache = decode(handle, cache, torch.from_numpy(tokens[:, t]),
                            t)
        assert _nerr(got, want) <= tol, t
    for t_slot, j_slot in zip(gather(cache), j_cache):
        for k in t_slot:
            assert _nerr(t_slot[k], np.asarray(j_slot[k])) <= tol, k


def test_mesh_step_takes_a_whole_tree_and_refuses_another_mesh(meshes):
    """A whole parameter tree is laid out first (same logits as a
    handle); a handle on another mesh is refused."""
    _, t_cfg = _configs("h2o-danube-1.8b")
    params = LMModel.create(t_cfg, seed=3, device="cpu").params
    tokens, pos = (torch.from_numpy(a) for a in _inputs(t_cfg, seed=4))
    kw = dict(param_specs=lm_param_specs(t_cfg), params_shape=params,
              backend="torch")
    step, _ = make_prefill_step(t_cfg, mesh=meshes[(2, 2)], **kw)
    step.timing = True
    a, _ = step(params, tokens, pos)
    b, _ = step(reshard(params, meshes[(2, 2)], step.pspecs), tokens, pos)
    assert torch.equal(a, b)
    assert len(step.last_stats) == 4
    assert all(s["collective_ms"] >= 0 and s["wall_ms"] > 0
               for s in step.last_stats)
    one = make_prefill_step(t_cfg, backend="torch")(params, tokens, pos)[0]
    assert _nerr(a, one) <= TOL
    other = reshard(params, meshes[(1, 4)], step.pspecs)
    with pytest.raises(ValueError, match="another mesh"):
        step(other, tokens, pos)


def test_reshard_then_gather_round_trips(meshes):
    """`reshard` then `gather` gives back every leaf bit for bit, on both
    meshes, for split, replicated and unevenly sized (pruned) leaves;
    the reference's own case (an (8, 8) arange over data and model)
    among them."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.arange(64.0).reshape(8, 8),
            "blocks": [({"a": torch.randn(6, 4, generator=g),
                         "b": torch.randn(3, generator=g)},
                        None)],
            "h": torch.randn(2, 4, 4, generator=g).to(torch.bfloat16)}
    specs = {"w": P("data", "model"),
             "blocks": [({"a": P("model", "data"), "b": P("model")}, None)],
             "h": P(None, "model", "data")}
    for mesh in meshes.values():
        handle = reshard(tree, mesh, specs)
        assert handle.nbytes >= sum(t.numel() * t.element_size()
                                    for t in tree_leaves(tree))
        back = gather(handle)
        for a, b in zip(tree_leaves(back), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert back["blocks"][0][1] is None
        handle.drop()


def test_remesh_state_keeps_the_logits(meshes):
    """Parameters laid out on (2, 2) and moved through host memory onto
    (1, 4) by `remesh_state` come back bit for bit and give the same
    prefill logits (within float32 rounding of another layout)."""
    _, t_cfg = _configs("jamba-v0.1-52b")
    params = LMModel.create(t_cfg, seed=5, device="cpu").params
    tokens, pos = (torch.from_numpy(a) for a in _inputs(t_cfg, seed=6))
    specs = lm_param_specs(t_cfg)
    outs, handles = [], []
    for shape in [(2, 2), (1, 4)]:
        step, _ = make_prefill_step(t_cfg, mesh=meshes[shape],
                                    param_specs=specs, params_shape=params,
                                    backend="torch")
        handle = (reshard(params, meshes[shape], step.pspecs) if not handles
                  else remesh_state(handles[-1], specs, meshes[shape]))
        handles.append(handle)
        outs.append(step(handle, tokens, pos)[0])
    for a, b in zip(tree_leaves(gather(handles[1])), tree_leaves(params)):
        assert torch.equal(a, b)
    assert _nerr(outs[1], outs[0]) <= TOL
