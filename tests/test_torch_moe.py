"""Port MoE parity: `repro_torch.nn.moe` against `repro.nn.moe` on the
same carried weights and numpy inputs (float32, seeded).

``out`` within 1e-5 in ``max|a-b| / (1 + max|b|)``: the experts' fan-in-2
``wi`` (std 0.71, the reference's initializer rule) makes the outputs
O(100), so float32 rounding is stated against the largest entry.  The
chosen experts, the slots that drop and ``dropped`` are equal; ``aux``
within 1e-6 relative."""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as j_moe
from repro.nn.layers import Initializer as JInit

from repro_torch.nn import moe as t_moe
from repro_torch.nn.layers import Initializer

TOL = 1e-5


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _carried(mp_j, d, seed):
    p, _ = j_moe.moe_init(JInit(jax.random.PRNGKey(seed)), d, mp_j)
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


def _mps(**kw):
    return j_moe.MoEParams(**kw), t_moe.MoEParams(**kw)


@pytest.mark.parametrize("norm_topk", [True, False])
def test_moe_apply_drops_as_reference(norm_topk):
    """64 tokens, 8 experts, top 2 at capacity factor 0.5: C = 8 slots an
    expert for 16 choices on average, so choices drop."""
    mp_j, mp_t = _mps(n_experts=8, topk=2, d_ff=48, capacity_factor=0.5,
                      router_norm_topk=norm_topk)
    jp, tp = _carried(mp_j, 32, seed=1)
    x = np.random.default_rng(2).standard_normal((4, 16, 32)).astype(
        np.float32)
    want, w_aux, w_drop = j_moe.moe_apply(jp, jnp.asarray(x), mp_j)
    got, g_aux, g_drop = t_moe.moe_apply(tp, torch.from_numpy(x), mp_t)
    assert got.shape == (4, 16, 32) and got.dtype == torch.float32
    assert 0.1 < float(w_drop) < 0.9
    assert float(g_drop) == float(w_drop)
    assert abs(float(g_aux) - float(w_aux)) <= 1e-6 * abs(float(w_aux))
    assert _nerr(got.numpy(), want) <= TOL


def test_chosen_experts_and_capacity_match_reference():
    mp_j, mp_t = _mps(n_experts=16, topk=4, d_ff=8)
    jp, tp = _carried(mp_j, 64, seed=3)
    x = np.random.default_rng(4).standard_normal((300, 64)).astype(np.float32)
    w_idx, w_w, (w_frac, w_mean), _ = j_moe._route(jp["router"],
                                                   jnp.asarray(x), mp_j)
    g_idx, g_w, (g_frac, g_mean), _ = t_moe._route(tp["router"],
                                                   torch.from_numpy(x), mp_t)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(g_frac.numpy(), np.asarray(w_frac))
    assert np.abs(g_w.numpy() - np.asarray(w_w)).max() <= 1e-6
    assert np.abs(g_mean.numpy() - np.asarray(w_mean)).max() <= 1e-6
    # the reference's capacity rule, C = max(8, ceil(T k cf / E))
    for T in (1, 4, 300, 8192):
        assert mp_t.capacity(T) == max(8, math.ceil(T * 4 * 1.25 / 16))


def test_moe_bfloat16_matches_reference():
    mp_j, mp_t = _mps(n_experts=4, topk=2, d_ff=32)
    jp, tp = _carried(mp_j, 32, seed=5)
    jp = {k: (v if k == "router" else v.astype(jnp.bfloat16))
          for k, v in jp.items()}
    tp = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tp.items()}
    x = np.random.default_rng(6).standard_normal((2, 8, 32)).astype(
        np.float32)
    want, _, _ = j_moe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), mp_j)
    got, _, _ = t_moe.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                                mp_t)
    assert got.dtype == torch.bfloat16 and tp["router"].dtype == torch.float32
    assert _nerr(got.float().numpy(), np.asarray(want, np.float32)) <= 2e-2


def test_moe_with_a_mesh_raises():
    """A mesh whose model axis does not divide the experts is refused
    before any rank runs (the reference asserts ``E % tp == 0``)."""
    _, mp_t = _mps(n_experts=4, topk=2, d_ff=8)
    init = Initializer(torch.Generator().manual_seed(0), device="cpu")
    p = t_moe.moe_init(init, 16, mp_t)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 3})
    with pytest.raises(ValueError, match="4 experts do not split"):
        t_moe.moe_apply(p, torch.zeros(1, 2, 16), mp_t, mesh=mesh)


def test_moe_with_a_mesh_matches_reference():
    """Expert parallelism on a (2, 2) mesh of gloo ranks against the
    reference's one-device `moe_apply` (the case of the reference's
    `tests/test_distributed.py`: 8 experts, top 2, capacity factor 8, so
    no choice drops): ``out`` within 1e-5 scaled, ``aux`` within 1e-6
    relative (the statistics are averaged over the ranks first), nothing
    dropped."""
    from repro_torch.launch.mesh import make_mesh
    mp_j, mp_t = _mps(n_experts=8, topk=2, d_ff=64, capacity_factor=8.0)
    jp, tp = _carried(mp_j, 32, seed=5)
    x = np.random.default_rng(1).standard_normal((4, 16, 32)).astype(
        np.float32)
    want, w_aux, w_drop = j_moe.moe_apply(jp, jnp.asarray(x), mp_j)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    got, g_aux, g_drop = t_moe.moe_apply(tp, torch.from_numpy(x), mp_t,
                                         mesh=mesh)
    assert got.shape == (4, 16, 32) and got.dtype == torch.float32
    assert _nerr(got.numpy(), want) <= TOL
    assert abs(g_aux - float(w_aux)) <= 1e-6 * abs(float(w_aux))
    assert g_drop == float(w_drop) == 0.0


def test_moe_init_shapes_dtypes_and_fan_in():
    """The router is float32 in a bf16 model; ``wi`` (E, d, 2, d_ff) takes
    fan-in 2 by the reference's rule (std 1/sqrt(2))."""
    mp_j, mp_t = _mps(n_experts=8, topk=2, d_ff=256)
    jp, _ = j_moe.moe_init(JInit(jax.random.PRNGKey(0), dtype=jnp.bfloat16),
                           128, mp_j)
    init = Initializer(torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.bfloat16)
    tp = t_moe.moe_init(init, 128, mp_t)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape
        assert str(tp[k].dtype).split(".")[-1] == str(v.dtype)
    assert abs(float(tp["wi"].float().std()) - 2 ** -0.5) < 0.01


def test_prefill_sized_batch_drops_where_decode_keeps():
    """The same tokens routed as one batch of 64 (prefill) and one at a
    time (decode): C is 8 either way, so a lone token never drops, while
    a skewed batch of 64 at capacity factor 1 does; the reference drops
    the same choices."""
    mp_j, mp_t = _mps(n_experts=4, topk=2, d_ff=8, capacity_factor=1.0)
    jp, tp = _carried(mp_j, 16, seed=7)
    x = np.random.default_rng(8).standard_normal((1, 64, 16)).astype(
        np.float32) + 1.0
    _, _, w_drop = j_moe.moe_apply(jp, jnp.asarray(x), mp_j)
    _, _, g_drop = t_moe.moe_apply(tp, torch.from_numpy(x), mp_t)
    assert float(g_drop) == float(w_drop) > 0
    for t in range(4):
        _, _, d1 = t_moe.moe_apply(tp, torch.from_numpy(x[:, t:t + 1]), mp_t)
        assert float(d1) == 0.0
    wide = dataclasses.replace(mp_t, capacity_factor=mp_t.n_experts / 2)
    _, _, d_all = t_moe.moe_apply(tp, torch.from_numpy(x), wide)
    assert float(d_all) == 0.0
