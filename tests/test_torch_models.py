"""Port model parity: `GNNModel.logits` for gcn, gin and gat with the
reference's parameters carried across by `params_from_jax`, against
`repro.models.gnn.build_gnn(backend="xla")` on the same graph, plan config
and features.

Tolerance: max|a-b| / (1+|b|) <= 1e-5 — GIN logits reach O(1e3), so raw
float32 accumulation-order noise scales with the logit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
import repro.models.gnn as j_gnn
from repro.core.model import AggConfig as JAggConfig

from repro_torch.core.model import AggConfig
from repro_torch.models import gnn as t_gnn

CFG = dict(gs=8, gpt=8, dt=64, src_win=128)


def _normalized_err(a, b):
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _models(arch, variant="folded", num_layers=2):
    g = j_csr.random_power_law(300, 6.0, seed=1)
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=24, hidden_dim=16,
                           num_classes=3, num_layers=num_layers,
                           backend="xla")
    jm = j_gnn.build_gnn(g, jcfg, reorder="on",
                         config=JAggConfig(**CFG, variant=variant),
                         key=jax.random.PRNGKey(3))
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=24, hidden_dim=16,
                           num_classes=3, num_layers=num_layers,
                           backend="torch", device="cpu")
    tm = t_gnn.build_gnn(g, tcfg, reorder="on",
                         config=AggConfig(**CFG, variant=variant))
    tm.params = t_gnn.params_from_jax(
        {k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    return g, jm, tm


@pytest.mark.parametrize("arch", ["gcn", "gin", "gat"])
def test_logits_match_reference(arch):
    g, jm, tm = _models(arch)
    np.testing.assert_array_equal(jm.plan.perm, tm.plan.perm)
    feat = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 24)).astype(np.float32)
    feat_p = jm.plan.renumber_features(feat)
    want = np.asarray(jm.logits(jm.params, jnp.asarray(feat_p)))
    got = tm.logits(tm.params, torch.from_numpy(feat_p))
    assert got.dtype == torch.float32 and got.shape == (g.num_nodes, 3)
    assert _normalized_err(got.numpy(), want) <= 1e-5


def test_gin_deep_logits_match_reference():
    """The paper's GIN depth (5 layers): logits grow to O(1e3)."""
    g, jm, tm = _models("gin", num_layers=5)
    feat = np.random.default_rng(1).standard_normal(
        (g.num_nodes, 24)).astype(np.float32)
    feat_p = jm.plan.renumber_features(feat)
    want = np.asarray(jm.logits(jm.params, jnp.asarray(feat_p)))
    got = tm.logits(tm.params, torch.from_numpy(feat_p)).numpy()
    assert _normalized_err(got, want) <= 1e-5


@pytest.mark.parametrize("arch", ["gcn", "gin", "gat"])
def test_init_params_shapes_match_reference(arch):
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=10, hidden_dim=6,
                           num_classes=4, num_layers=3)
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=10, hidden_dim=6,
                           num_classes=4, num_layers=3, device="cpu")
    jp = j_gnn.init_gnn_params(jcfg, jax.random.PRNGKey(0))
    tp = t_gnn.init_gnn_params(tcfg, torch.Generator().manual_seed(0))
    assert set(jp) == set(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert tp[k].dtype == torch.float32
        # same scale: 1/sqrt(fan_in)-normalized normals
        assert abs(float(tp[k].std()) - float(np.std(np.asarray(jp[k])))) < 0.5
    tp2 = t_gnn.init_gnn_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(tp[k], tp2[k]) for k in tp)


def test_params_from_jax_keeps_keys_shapes_f32():
    src = {"w0": np.ones((3, 2), np.float64), "a0s": np.zeros(2, np.float16)}
    out = t_gnn.params_from_jax(src, "cpu")
    assert set(out) == set(src)
    assert all(v.dtype == torch.float32 for v in out.values())
    assert out["w0"].shape == (3, 2)


def test_gcn_edge_values_match_reference():
    g = j_csr.random_power_law(120, 5.0, seed=2)
    gj, vj = j_gnn.gcn_edge_values(g)
    gt, vt = t_gnn.gcn_edge_values(g)
    np.testing.assert_array_equal(gj.indices, gt.indices)
    np.testing.assert_array_equal(vj, vt)


def test_entry_points_need_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    cfg = t_gnn.GNNConfig(arch="gcn", in_dim=4, hidden_dim=4, num_classes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_gnn.init_gnn_params(cfg)
    g = j_csr.random_power_law(50, 3.0, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_gnn.build_gnn(g, cfg, reorder="off",
                        config=AggConfig(gs=4, gpt=8, dt=8, src_win=64))
    ok = t_gnn.build_gnn(g, dataclasses.replace(cfg, device="cpu",
                                                backend="torch"),
                         reorder="off",
                         config=AggConfig(gs=4, gpt=8, dt=8, src_win=64))
    assert ok.executor.device == torch.device("cpu")
