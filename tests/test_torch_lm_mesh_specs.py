"""The LM mesh's specs on the host (no ranks): `repro_torch.nn.layers`'
sharding rules, `repro_torch.nn.transformer.lm_param_specs`,
`repro_torch.distributed.sharding`, `repro_torch.models.lm.
decode_cache_specs`, `repro_torch.runtime.elastic.plan_mesh` and
`repro_torch.launch.mesh.make_production_mesh`, held against their
`repro.*` counterparts.

The reference reads only ``axis_names`` and ``shape`` off a mesh in
`valid_spec` and `decode_cache_specs`, so both packages get the same
stub mesh and the main process keeps seeing one JAX device.  Specs are
compared entry for entry (a `PartitionSpec` is a tuple in both)."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.models import lm as j_lm
from repro.nn import layers as j_layers
from repro.nn import transformer as j_tf
from repro.runtime import elastic as j_elastic

from repro_torch import configs as t_configs
from repro_torch.distributed import sharding as t_sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm as t_lm
from repro_torch.models.lm import LMModel
from repro_torch.nn import layers as t_layers
from repro_torch.nn import transformer as t_tf
from repro_torch.runtime.elastic import plan_mesh

ARCHS = ["musicgen-large", "gemma2-2b", "gemma2-9b", "starcoder2-15b",
         "h2o-danube-1.8b", "jamba-v0.1-52b", "qwen3-moe-235b-a22b",
         "olmoe-1b-7b", "qwen2-vl-2b", "falcon-mamba-7b"]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x3": ((1, 3), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@dataclasses.dataclass
class StubMesh:
    """What `valid_spec` and `decode_cache_specs` read off a mesh."""

    axis_names: tuple
    shape: dict


def _stub(name: str) -> StubMesh:
    shape, axes = MESHES[name]
    return StubMesh(axis_names=axes, shape=dict(zip(axes, shape)))


def _ref_specs(j_cfg):
    """The reference's (shapes, specs) of `lm_init` without allocating
    (the specs are Python objects built while tracing)."""
    got = {}

    def init(key):
        params, got["specs"] = j_tf.lm_init(j_cfg, key)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, got["specs"]


def _pairs(t_tree, j_tree, stacked=False):
    """(port leaf, reference leaf, stacked) over the port's tree; a port
    block leaf pairs with the reference's slot leaf of every repeat."""
    if isinstance(t_tree, dict):
        assert set(t_tree) == set(j_tree)
        for k in t_tree:
            yield from _pairs(t_tree[k], j_tree[k], stacked)
    elif isinstance(t_tree, list):            # blocks: repeats x slots
        for rep in t_tree:
            assert len(rep) == len(j_tree)
            for t_slot, j_slot in zip(rep, j_tree):
                yield from _pairs(t_slot, j_slot, True)
    else:
        yield t_tree, j_tree, stacked


@pytest.mark.parametrize("name", ARCHS)
def test_lm_param_specs_match_reference(name):
    """Every leaf of `lm_init`'s parameters (full width, on meta) has the
    reference's spec, less the layers entry of a block leaf."""
    j_cfg = j_configs.get_arch(name).full()
    t_cfg = t_configs.get_arch(name).full()
    _, j_specs = _ref_specs(j_cfg)
    specs = t_tf.lm_param_specs(t_cfg)
    params = LMModel.create(t_cfg, device="meta").params
    n = 0
    for (sp, j_sp, stacked), (leaf, _, _) in zip(
            _pairs(specs, j_specs), _pairs(params, j_specs)):
        want = tuple(j_sp)[1:] if stacked else tuple(j_sp)
        if stacked:
            assert tuple(j_sp)[0] is None
        assert tuple(sp) == want
        assert len(sp) == leaf.dim()
        n += 1
    assert n == len(t_sharding.tree_leaves(params))


def test_sharding_rules_match_reference():
    """`ShardingRules.spec`, with the rule that no two dims of one tensor
    map onto one mesh axis, and `replace`."""
    names = [None, "embed", "mlp", "vocab", "heads", "kv_heads",
             "experts", "expert_mlp", "inner", "batch", "act_heads"]
    rules = [(t_layers.DEFAULT_RULES, j_layers.DEFAULT_RULES),
             (t_layers.DEFAULT_RULES.replace(kv_heads="model",
                                             embed=("pod", "data")),
              j_layers.DEFAULT_RULES.replace(kv_heads="model",
                                             embed=("pod", "data")))]
    for t_rules, j_rules in rules:
        for logical in itertools.product(names, repeat=3):
            assert tuple(t_rules.spec(*logical)) == \
                tuple(j_rules.spec(*logical)), logical
    assert t_layers.DEFAULT_MAPPING == j_layers.DEFAULT_MAPPING


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "olmoe-1b-7b",
                                  "gemma2-2b", "qwen2-vl-2b"])
def test_prune_specs_for_mesh_matches_reference(name, mesh):
    """`prune_specs_for_mesh` (so `valid_spec` on every leaf) on the
    reduced configs' parameters: an axis that is missing or does not
    divide the dim drops to None."""
    stub = _stub(mesh)
    j_cfg = j_configs.get_arch(name).reduced()
    t_cfg = t_configs.get_arch(name).reduced()
    j_shapes, j_specs = _ref_specs(j_cfg)
    want = j_sharding.prune_specs_for_mesh(stub, j_specs, j_shapes)
    params = LMModel.create(t_cfg, device="meta").params
    got = t_sharding.prune_specs_for_mesh(stub, t_tf.lm_param_specs(t_cfg),
                                          params)
    pruned = 0
    for (sp, j_sp, stacked), (orig, _, _) in zip(
            _pairs(got, want), _pairs(t_tf.lm_param_specs(t_cfg), want)):
        assert tuple(sp) == (tuple(j_sp)[1:] if stacked else tuple(j_sp))
        pruned += tuple(sp) != tuple(orig)
    # on (1, 3) the reduced widths (4 heads, 256 vocab, ...) do not split
    assert (pruned > 0) == (mesh == "1x3")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_valid_spec_matches_reference(mesh):
    stub = _stub(mesh)
    entries = [None, "data", "model", "pod", ("pod", "data"),
               ("data", "model"), "absent"]
    for spec in itertools.product(entries, repeat=2):
        for shape in [(8, 4), (6, 2), (2, 3), (4, 8, 5)]:
            j = j_sharding.valid_spec(stub, jax.sharding.PartitionSpec(
                *spec), shape)
            t = t_sharding.valid_spec(stub, t_layers.PartitionSpec(*spec),
                                      shape)
            assert tuple(t) == tuple(j), (spec, shape)
    assert tuple(t_sharding.batch_spec(stub, 2)) == \
        tuple(j_sharding.batch_spec(stub, 2))
    assert t_sharding.batch_axes_for(stub) == \
        j_sharding.batch_axes_for(stub)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_index_tiles_every_leaf(mesh):
    """Over a mesh's ranks the slices of a leaf cover each element once
    per rank of the axes its spec does not split it over."""
    stub = _stub(mesh)
    dims = tuple(stub.shape[a] for a in stub.axis_names)
    n = int(np.prod(dims))
    for spec in [t_layers.PartitionSpec("model", "data"),
                 t_layers.PartitionSpec(("pod", "data"), None),
                 t_layers.PartitionSpec(None, ("data", "model"))]:
        shape = (8, 8)
        sp = t_sharding.valid_spec(stub, spec, shape)
        hits = np.zeros(shape, np.int64)
        for r in range(n):
            coords = dict(zip(stub.axis_names, np.unravel_index(r, dims)))
            hits[t_sharding.shard_index(stub, sp, shape, coords)] += 1
        used = {a for e in sp if e for a in (e if isinstance(e, tuple)
                                             else (e,))}
        copies = int(np.prod([stub.shape[a] for a in stub.axis_names
                              if a not in used]))
        assert (hits == copies).all(), (spec, sp)
        placed = t_sharding.named_shardings(stub, {"w": spec}, {"w": shape})
        assert placed["w"] == t_sharding.NamedSharding(stub, sp)


@pytest.mark.parametrize("name,mesh", [("gemma2-2b", "2x2"),
                                       ("gemma2-2b", "1x4"),
                                       ("jamba-v0.1-52b", "2x2"),
                                       ("jamba-v0.1-52b", "1x4"),
                                       ("falcon-mamba-7b", "2x2x2")])
def test_decode_cache_specs_match_reference(name, mesh):
    """KV heads over ``model`` where they divide (gemma2-2b reduced has
    2: heads on (2, 2)), else the cache sequence (on (1, 4)); Mamba's
    state and conv tail over ``d_inner``; batch over (pod, data)."""
    stub = _stub(mesh)
    j_cfg = j_configs.get_arch(name).reduced()
    t_cfg = t_configs.get_arch(name).reduced()
    j_cache = j_tf.init_lm_cache(j_cfg, 4, max_seq=16, dtype=jnp.float32)
    t_cache = t_tf.init_lm_cache(t_cfg, 4, max_seq=16, dtype=torch.float32,
                                 device="meta")
    want = j_lm.decode_cache_specs(j_cfg, stub, j_cache)
    got = t_lm.decode_cache_specs(t_cfg, stub, t_cache)
    layouts = set()
    for t_slot, j_slot in zip(got, want):
        assert set(t_slot) == set(j_slot)
        for k in t_slot:
            assert tuple(t_slot[k]) == tuple(j_slot[k]), (k, t_slot[k])
            layouts.add(tuple(t_slot[k]))
    if name == "gemma2-2b":
        kv = (None, "data", None, "model", None) if mesh == "2x2" else \
            (None, "data", "model", None, None)
        assert kv in layouts


def test_plan_mesh_factorizations():
    """The cases of the reference's `tests/test_runtime.py`; a count the
    pods and model ranks do not divide raises (the reference asserts)."""
    for args, kw in [((512,), dict(model_parallel=16, pods=2)),
                     ((384,), dict(model_parallel=16, pods=2)),
                     ((256,), dict(model_parallel=16)),
                     ((8,), dict(model_parallel=2)),
                     ((4,), dict(model_parallel=4))]:
        got, want = plan_mesh(*args, **kw), j_elastic.plan_mesh(*args, **kw)
        assert (got.shape, got.axes) == (want.shape, want.axes)
    assert plan_mesh(384, model_parallel=16, pods=2).shape == (2, 12, 16)
    with pytest.raises(ValueError, match="do not split"):
        plan_mesh(100, model_parallel=16, pods=2)
    with pytest.raises(AssertionError):
        j_elastic.plan_mesh(100, model_parallel=16, pods=2)


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_make_production_mesh_raises_without_its_cards(multi_pod, need):
    """The production meshes need a card a rank; this machine has none
    (or fewer), so the call raises naming what it needs, before any rank
    starts."""
    with pytest.raises(ValueError, match=f"needs {need} ranks, one card "
                                         f"each"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
