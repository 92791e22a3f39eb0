"""Port gradient parity: the edge-value cotangent oracle, the
`torch.autograd.Function` of `repro_torch.kernels.ops.aggregate` (backward
over the transposed schedule), `plan_for(with_backward=True)` and model
loss gradients, each against the JAX package on the same inputs (made
with numpy from a seed).

The port runs its plain PyTorch versions on the CPU (``backend="torch"``);
the reference runs its Pallas kernels in interpret mode or its XLA
lowering.  Tolerances, stated per test:
  * per-slot dot products: rtol/atol 1e-5 (float32, summation order);
  * gradients: ``max|a-b| / (1 + |b|) <= 1e-5`` (normalized: GIN's and
    hub rows' sums grow with degree, so raw float32 order noise scales).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
import repro.models.gnn as j_gnn
from repro.core.advisor import plan_for as j_plan_for
from repro.core.model import AggConfig as JAggConfig
from repro.core.partition import (partition_graph as j_partition_graph,
                                  transpose_graph as j_transpose_graph)
from repro.kernels import ops as j_ops
from repro.kernels.group_aggregate import group_edge_grad_pallas
from repro.kernels.ref import group_edge_grad_ref as j_edge_grad_ref

from repro_torch.core.advisor import plan_for
from repro_torch.core.model import AggConfig
from repro_torch.core.partition import partition_graph, transpose_graph
from repro_torch.kernels import group_aggregate as t_ga
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.ref import group_edge_grad_ref
from repro_torch.models import gnn as t_gnn

VARIANTS = ["folded", "slot_onehot", "direct"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _normalized_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _pair(g, ev, *, gs=8, gpt=8, ont=8, src_win=64):
    """Forward and transposed partitions (the port's; bit-equal to the
    reference's, `tests/test_torch_planner.py`) + the edge permutation."""
    p = partition_graph(g, gs=gs, gpt=gpt, ont=ont, src_win=src_win,
                        edge_vals=ev)
    gT, evT, perm = transpose_graph(g, ev)
    pT = partition_graph(gT, gs=gs, gpt=gpt, ont=ont, src_win=src_win,
                         edge_vals=evT)
    return p, pT, perm


# ---------------------------------------------------------------------------
# the edge-value cotangent oracle and its wrapper
# ---------------------------------------------------------------------------

def _real(per_slot, p):
    """Real slots only: padded slots are don't-care in every version."""
    per_slot = np.asarray(per_slot).reshape(-1, p.gs)
    return per_slot[p.edge_slot, p.edge_pos]


@pytest.mark.parametrize("d", [1, 20])
def test_edge_grad_ref_matches_reference(d):
    g = j_csr.random_power_law(160, 5.0, seed=4)
    p, _, _ = _pair(g, None)
    dt = t_ops.dim_tile(16, d, "float32")
    d_pad = -(-d // dt) * dt
    rng = np.random.default_rng(d)
    grad = np.zeros((p.padded_out_rows, d_pad), np.float32)
    feat = np.zeros((p.padded_src_rows, d_pad), np.float32)
    grad[:p.num_nodes, :d] = rng.standard_normal((p.num_nodes, d))
    feat[:p.num_nodes, :d] = rng.standard_normal((p.num_nodes, d))
    got = group_edge_grad_ref(torch.from_numpy(grad), torch.from_numpy(feat),
                              torch.from_numpy(p.nbrs),
                              torch.from_numpy(p.local_node),
                              torch.from_numpy(p.tile_node_block), p.ont)
    assert got.dtype == torch.float32 and got.shape == p.nbrs.shape
    want = j_edge_grad_ref(jnp.asarray(grad), jnp.asarray(feat), p.nbrs,
                           p.local_node, p.tile_node_block, p.ont)
    np.testing.assert_allclose(_real(got, p), _real(want, p), **F32_TOL)
    # column chunking changes no term
    small = group_edge_grad_ref(torch.from_numpy(grad),
                                torch.from_numpy(feat),
                                torch.from_numpy(p.nbrs),
                                torch.from_numpy(p.local_node),
                                torch.from_numpy(p.tile_node_block), p.ont,
                                max_elems=p.nbrs.size)
    np.testing.assert_allclose(_real(small, p), _real(got, p), **F32_TOL)
    for variant in VARIANTS:
        kern = group_edge_grad_pallas(
            jnp.asarray(grad), jnp.asarray(feat), jnp.asarray(p.nbrs),
            jnp.asarray(p.local_node), jnp.asarray(p.tile_node_block),
            jnp.asarray(p.tile_window), gs=p.gs, gpt=p.gpt, ont=p.ont,
            src_win=p.src_win, dt=dt, variant=variant, interpret=True)
        np.testing.assert_allclose(_real(got, p), _real(kern, p), **F32_TOL,
                                   err_msg=variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_edge_grad_wrapper_routes_cpu_tensors_to_plain_version(variant):
    g = j_csr.random_power_law(90, 4.0, seed=5)
    p, _, _ = _pair(g, None)
    s = t_ops.DeviceSchedule(p, "cpu")
    grad = torch.randn(p.padded_out_rows, 8)
    feat = torch.randn(p.padded_src_rows, 8)
    before = dict(t_ga.launches)
    out = t_ga.group_edge_grad(grad, feat, s.nbrs, s.local_node,
                               s.tile_node_block, s.tile_window, s.run_start,
                               gs=s.gs, gpt=s.gpt, ont=s.ont,
                               src_win=s.src_win, dt=8, variant=variant)
    assert t_ga.launches[t_ga.EDGE_GRAD_PLAIN] == \
        before[t_ga.EDGE_GRAD_PLAIN] + 1
    assert all(t_ga.launches[k] == before[k]
               for k in set(t_ga.EDGE_GRAD_KERNEL_OF_VARIANT.values()))
    ref = group_edge_grad_ref(grad, feat, s.nbrs, s.local_node,
                              s.tile_node_block, s.ont)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # the block kernel reads only the real edges' slots, so every
    # variant's schedule runs it
    assert t_ga.EDGE_GRAD_KERNEL_OF_VARIANT[variant] == \
        "group_edge_grad[block]"


@pytest.mark.parametrize("transposed", [False, True])
def test_slot_of_edge_is_each_edges_flat_slot(transposed):
    """`DeviceSchedule.slot_of_edge`, the slots the block edge-gradient
    kernel computes: each real edge's ``edge_slot * gs + edge_pos``, int32,
    on forward and transposed schedules; every real slot once."""
    g = j_csr.random_power_law(150, 5.0, seed=12)
    p, pT, perm = _pair(g, None, gs=4)
    s = (t_ops.DeviceSchedule(pT, "cpu", edge_perm=perm) if transposed
         else t_ops.DeviceSchedule(p, "cpu"))
    part = pT if transposed else p
    want = part.edge_slot.astype(np.int64) * part.gs + part.edge_pos
    assert s.slot_of_edge.dtype == torch.int32
    np.testing.assert_array_equal(s.slot_of_edge.numpy(), want)
    assert len(np.unique(want)) == part.num_edges
    assert (part.edge_val.reshape(-1)[want] != 0).all()


@pytest.mark.parametrize("d", [3, 16])
def test_edge_cotangent_gathers_the_plain_per_slot_dots(d):
    """The plain per-slot cotangent gathered through `slot_of_edge` is
    `_edge_cotangent`'s output, and both match the reference's
    `group_edge_grad_ref` (its plain path) at the same real slots, on the
    same numpy-seeded inputs: float32, rtol/atol 1e-5 (summation order)."""
    g = j_csr.random_power_law(140, 5.0, seed=d)
    p, _, _ = _pair(g, None, gs=4)
    s = t_ops.DeviceSchedule(p, "cpu")
    rng = np.random.default_rng(d)
    cot = rng.standard_normal((g.num_nodes, d)).astype(np.float32)
    feat = rng.standard_normal((g.num_nodes, d)).astype(np.float32)
    got = t_ops._edge_cotangent(torch.from_numpy(cot), torch.from_numpy(feat),
                                s, dt=16, backend="torch", variant="folded")
    assert got.dtype == torch.float32 and got.shape == (g.num_edges,)
    pad = lambda x, rows: np.pad(x, ((0, rows - x.shape[0]), (0, 0)))
    per_slot = group_edge_grad_ref(
        torch.from_numpy(pad(cot, p.padded_out_rows)),
        torch.from_numpy(pad(feat, p.padded_src_rows)), s.nbrs,
        s.local_node, s.tile_node_block, p.ont)
    torch.testing.assert_close(per_slot.reshape(-1)[s.slot_of_edge], got,
                               rtol=0, atol=0)
    want = j_edge_grad_ref(jnp.asarray(pad(cot, p.padded_out_rows)),
                           jnp.asarray(pad(feat, p.padded_src_rows)), p.nbrs,
                           p.local_node, p.tile_node_block, p.ont)
    np.testing.assert_allclose(got.numpy(), _real(want, p), **F32_TOL)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrapper takes
    its CUDA path: every check before the launch runs, and a refusal
    raises before anything touches CUDA."""

    @property
    def is_cuda(self):
        return True


def _edge_grad_refusals(variant):
    """On the card the edge-gradient wrapper refuses, before any launch, a
    missing per-edge slot index and one of the wrong dtype, device, rank or
    length, and rows its 16-byte loads cannot take."""
    g = j_csr.random_power_law(90, 4.0, seed=5)
    p, _, _ = _pair(g, None)
    s = t_ops.DeviceSchedule(p, "cpu")
    before = dict(t_ga.launches)

    def call(slots, width=8, dt=8, grad=None):
        feat = torch.randn(p.padded_src_rows, width).as_subclass(_OnCard)
        grad = torch.randn(p.padded_out_rows, width) if grad is None else grad
        return t_ga.group_edge_grad(
            grad, feat, s.nbrs, s.local_node, s.tile_node_block,
            s.tile_window, s.run_start, gs=s.gs, gpt=s.gpt, ont=s.ont,
            src_win=s.src_win, dt=dt, variant=variant, slot_of_edge=slots)

    with pytest.raises(ValueError, match="slot_of_edge"):
        call(None)
    with pytest.raises(TypeError, match="slot_of_edge"):
        call(s.slot_of_edge.long())
    with pytest.raises(ValueError, match="slot_of_edge"):
        call(s.slot_of_edge.to("meta"))
    with pytest.raises(ValueError, match="slot_of_edge"):
        call(s.slot_of_edge.reshape(1, -1))
    with pytest.raises(ValueError, match="slot_of_edge"):
        call(torch.zeros(s.nbrs.numel() + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="slot_of_edge"):
        call(s.slot_of_edge[:0])
    with pytest.raises(ValueError, match="16 bytes"):
        call(s.slot_of_edge, width=6, dt=6)
    base = torch.randn(p.padded_out_rows * 8 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(s.slot_of_edge, grad=base[1:].view(p.padded_out_rows, 8))
    assert t_ga.launches == before


def test_block_edge_grad_refuses_a_malformed_slot_index():
    _edge_grad_refusals("slot_onehot")


def test_direct_edge_grad_refuses_a_malformed_slot_index():
    """`direct` runs the block kernel too, so its wrapper refuses what the
    one-hot variants' does."""
    _edge_grad_refusals("direct")


class _ReachedBuild(Exception):
    pass


def test_pinned_gs128_direct_edge_grad_has_no_group_size_limit(monkeypatch):
    """A pinned `direct` config at gs 128 (Eq. 3 allows it at dt <= 512)
    plans, its per-slot edge cotangent on the CPU matches the reference's
    `group_edge_grad_ref` at the real slots (float32, rtol/atol 1e-5), and
    on the card its wrapper passes every check and goes on to build the
    kernel: no limit on the group size stands before the launch."""
    g = j_csr.random_power_law(300, 6.0, seed=21)
    cfg = AggConfig(gs=128, gpt=8, dt=16, src_win=128, variant="direct")
    plan = plan_for(g, arch="gat", in_dim=8, hidden_dim=8, config=cfg,
                    with_backward=True)
    assert (plan.config.gs, plan.config.variant) == (128, "direct")
    p, s = plan.partition, plan.sched("cpu")
    rng = np.random.default_rng(21)
    grad = rng.standard_normal((p.padded_out_rows, 16)).astype(np.float32)
    feat = rng.standard_normal((p.padded_src_rows, 16)).astype(np.float32)
    kw = dict(gs=s.gs, gpt=s.gpt, ont=s.ont, src_win=s.src_win, dt=16,
              variant="direct", slot_of_edge=s.slot_of_edge)
    got = t_ga.group_edge_grad(torch.from_numpy(grad), torch.from_numpy(feat),
                               s.nbrs, s.local_node, s.tile_node_block,
                               s.tile_window, s.run_start, **kw)
    want = j_edge_grad_ref(jnp.asarray(grad), jnp.asarray(feat), p.nbrs,
                           p.local_node, p.tile_node_block, p.ont)
    np.testing.assert_allclose(_real(got.numpy(), p), _real(want, p),
                               **F32_TOL)

    def load(name):
        raise _ReachedBuild(name)

    monkeypatch.setattr(t_ga.build, "load", load)
    with pytest.raises(_ReachedBuild, match="group_edge_grad"):
        t_ga.group_edge_grad(torch.from_numpy(grad),
                             torch.from_numpy(feat).as_subclass(_OnCard),
                             s.nbrs, s.local_node, s.tile_node_block,
                             s.tile_window, s.run_start, **kw)


# ---------------------------------------------------------------------------
# the autograd Function against jax.grad through the reference's custom VJP
# ---------------------------------------------------------------------------

def _grads_both(variant, dynamic, seed, n=150, d=20, dtype="float32"):
    g = j_csr.random_power_law(n, 5.0, seed=seed)
    rng = np.random.default_rng(seed)
    ev0 = rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32)
    p, pT, perm = _pair(g, ev0)
    feat = rng.standard_normal((g.num_nodes, d)).astype(np.float32)
    cot = rng.standard_normal((g.num_nodes, d)).astype(np.float32)
    ev = rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32)

    # reference: jax.grad through the interpreted Pallas kernels
    js, jsb = j_ops.DeviceSchedule(p), j_ops.DeviceSchedule(pT, edge_perm=perm)

    def j_loss(f, e):
        out = j_ops.aggregate(f, js, dt=16, backend="pallas_interpret",
                              variant=variant,
                              edge_values=e if dynamic else None,
                              sched_bwd=jsb)
        return (out * jnp.asarray(cot)).sum()

    jf, je = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(feat),
                                               jnp.asarray(ev))

    # port: the autograd Function (plain versions) and native autograd
    ts = t_ops.DeviceSchedule(p, "cpu")
    tsb = t_ops.DeviceSchedule(pT, "cpu", edge_perm=perm)

    def t_grads(sched_bwd):
        f = torch.tensor(feat, requires_grad=True)
        e = torch.tensor(ev, requires_grad=True)
        out = t_ops.aggregate(f, ts, dt=16, backend="torch", variant=variant,
                              edge_values=e if dynamic else None,
                              sched_bwd=sched_bwd)
        (out * torch.from_numpy(cot)).sum().backward()
        return f.grad, e.grad

    return (np.asarray(jf), np.asarray(je)), t_grads(tsb), t_grads(None)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dynamic", [False, True])
def test_aggregate_grads_match_reference(variant, dynamic):
    (jf, je), (tf, te), (nf, ne) = _grads_both(variant, dynamic, seed=11)
    assert tf.dtype == torch.float32
    assert _normalized_err(tf.numpy(), jf) <= 1e-5
    assert _normalized_err(tf.numpy(), nf.numpy()) <= 1e-5
    if dynamic:
        assert te.dtype == torch.float32
        assert _normalized_err(te.numpy(), je) <= 1e-5
        assert _normalized_err(te.numpy(), ne.numpy()) <= 1e-5
    else:
        assert te is None and ne is None      # static values take no grad


def test_backward_casts_cotangent_to_feat_dtype():
    """bf16 features: the cotangents come back in the primals' dtypes and
    agree with the float32 computation on the same (bf16-exact) inputs
    within bf16 rounding, ``max|a-b| / (1 + max|b|) <= 2e-2`` (the serving
    driver's bf16 limit, on the tensor's scale: the cotangent is rounded
    to bf16 before the transposed aggregation, whose sums stay float32 but
    cancel, so a per-entry relative bound would not hold)."""
    g = j_csr.random_power_law(120, 4.0, seed=7)
    p, pT, perm = _pair(g, None)
    ts = t_ops.DeviceSchedule(p, "cpu")
    tsb = t_ops.DeviceSchedule(pT, "cpu", edge_perm=perm)
    rng = np.random.default_rng(7)
    feat = torch.tensor(rng.standard_normal((g.num_nodes, 16)),
                        dtype=torch.bfloat16)
    ev = torch.tensor(rng.uniform(0.5, 1.5, g.num_edges), dtype=torch.float32)
    grads = []
    for dtype in (torch.bfloat16, torch.float32):
        f = feat.to(dtype).detach().requires_grad_(True)
        e = ev.clone().requires_grad_(True)
        out = t_ops.aggregate(f, ts, backend="torch", edge_values=e,
                              sched_bwd=tsb, out_dtype=dtype)
        assert out.dtype == dtype
        out.float().square().sum().backward()
        grads.append((f.grad, e.grad))
    (tf, te), (ff, fe) = grads
    assert tf.dtype == torch.bfloat16 and te.dtype == torch.float32
    for a, b in ((tf.float(), ff), (te, fe)):
        assert float((a - b).abs().max()) <= 2e-2 * (1 + float(b.abs().max()))


def test_missing_edge_perm_raises():
    g = j_csr.random_power_law(40, 3.0, seed=14)
    ev = np.ones(g.num_edges, np.float32)
    p, pT, _ = _pair(g, ev, gs=4, gpt=4, src_win=32)
    ts = t_ops.DeviceSchedule(p, "cpu")
    no_perm = t_ops.DeviceSchedule(pT, "cpu")
    with pytest.raises(ValueError, match="edge_perm"):
        t_ops.aggregate(torch.zeros(g.num_nodes, 4), ts, backend="torch",
                        edge_values=torch.from_numpy(ev), sched_bwd=no_perm)
    # static values need no permutation
    t_ops.aggregate(torch.zeros(g.num_nodes, 4), ts, backend="torch",
                    sched_bwd=no_perm)


def test_edgeless_schedule_gives_zero_gradients():
    """The early-return path (no tiles) still returns zero cotangents."""
    g = j_csr.from_edges(12, np.array([], np.int64), np.array([], np.int64))
    p, pT, perm = _pair(g, None)
    assert p.num_tiles == 0 and pT.num_tiles == 0
    ts = t_ops.DeviceSchedule(p, "cpu")
    tsb = t_ops.DeviceSchedule(pT, "cpu", edge_perm=perm)
    f = torch.randn(12, 5, requires_grad=True)
    e = torch.zeros(0, requires_grad=True)
    out = t_ops.aggregate(f, ts, backend="torch", edge_values=e,
                          sched_bwd=tsb)
    (out.sum() + f.sum()).backward()
    assert torch.equal(f.grad, torch.ones(12, 5))
    assert e.grad is not None and e.grad.shape == (0,)


# ---------------------------------------------------------------------------
# planning the backward pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_vals", [False, True])
def test_plan_for_with_backward_matches_reference(with_vals):
    g = j_csr.random_power_law(250, 6.0, seed=9)
    ev = (np.random.default_rng(9).uniform(0.1, 2.0, g.num_edges)
          .astype(np.float32) if with_vals else None)
    cfg = dict(gs=8, gpt=16, dt=64, src_win=128)
    tp = plan_for(g, arch="gat", in_dim=24, hidden_dim=16, edge_vals=ev,
                  config=AggConfig(**cfg), with_backward=True)
    jp = j_plan_for(g, arch="gat", in_dim=24, hidden_dim=16, edge_vals=ev,
                    config=JAggConfig(**cfg), with_backward=True)
    np.testing.assert_array_equal(tp.edge_perm_bwd, jp.edge_perm_bwd)
    for f in ("nbrs", "edge_val", "local_node", "tile_node_block",
              "tile_window", "edge_slot", "edge_pos"):
        np.testing.assert_array_equal(getattr(tp.partition_bwd, f),
                                      getattr(jp.partition_bwd, f), err_msg=f)
    sb = tp.sched_bwd("cpu")
    assert sb is tp.sched_bwd("cpu")                 # cached
    assert sb.edge_perm is not None and sb.num_nodes == g.num_nodes
    assert plan_for(g, config=AggConfig(**cfg)).sched_bwd("cpu") is None
    jT, _, jperm = j_transpose_graph(g, ev)
    np.testing.assert_array_equal(jperm, tp.edge_perm_bwd)
    jpT = j_partition_graph(jT, **{k: cfg[k] for k in ("gs", "gpt",
                                                       "src_win")})
    np.testing.assert_array_equal(jpT.nbrs, tp.partition_bwd.nbrs)


# ---------------------------------------------------------------------------
# model loss gradients with the reference's parameters
# ---------------------------------------------------------------------------

CFG = dict(gs=8, gpt=8, dt=64, src_win=128)


@pytest.mark.parametrize("arch,variant", [("gcn", "folded"),
                                          ("gin", "direct"),
                                          ("gat", "slot_onehot"),
                                          ("gat", "direct")])
def test_model_loss_grads_match_reference(arch, variant):
    g = j_csr.random_power_law(220, 5.0, seed=31)
    jcfg = j_gnn.GNNConfig(arch=arch, in_dim=16, hidden_dim=8, num_classes=4,
                           num_layers=2, backend="xla")
    jm = j_gnn.build_gnn(g, jcfg, reorder="on",
                         config=JAggConfig(**CFG, variant=variant),
                         key=jax.random.PRNGKey(2))
    tcfg = t_gnn.GNNConfig(arch=arch, in_dim=16, hidden_dim=8, num_classes=4,
                           num_layers=2, backend="torch", device="cpu")
    tm = t_gnn.build_gnn(g, tcfg, reorder="on",
                         config=AggConfig(**CFG, variant=variant),
                         with_backward=True)
    assert tm.executor.sched_bwd is not None
    rng = np.random.default_rng(3)
    feat = jm.plan.renumber_features(
        rng.standard_normal((g.num_nodes, 16)).astype(np.float32))
    labels = jm.plan.renumber_features(
        rng.integers(0, 4, g.num_nodes).astype(np.int32))
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jm.params, jnp.asarray(feat), jnp.asarray(labels))
    params = t_gnn.params_from_jax(
        {k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    tl, metrics = tm.loss(leaves, torch.from_numpy(feat),
                          torch.from_numpy(labels).long())
    tl.backward()
    assert set(metrics) == {"loss", "accuracy"}
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * (1 + abs(float(jl)))
    for k in jg:
        assert _normalized_err(leaves[k].grad.numpy(), jg[k]) <= 1e-5, k


def test_gat_attention_shift_takes_no_gradient():
    """The softmax shift ``e.max()`` is detached (the reference's
    stop_gradient): the gradient equals the unshifted softmax's."""
    g = j_csr.random_power_law(80, 4.0, seed=6)
    tcfg = t_gnn.GNNConfig(arch="gat", in_dim=8, hidden_dim=8, num_classes=3,
                           num_layers=1, backend="torch", device="cpu")
    tm = t_gnn.build_gnn(g, tcfg, reorder="off",
                         config=AggConfig(gs=4, gpt=8, dt=8, src_win=64))
    params = {k: v.requires_grad_(True) for k, v in tm.params.items()}
    feat = torch.randn(g.num_nodes, 8, generator=torch.Generator()
                       .manual_seed(0))
    tm.logits(params, feat).square().sum().backward()
    got = {k: v.grad.clone() for k, v in params.items()}
    # the same function with the shift left out entirely
    rows, cols = tm._edges
    z = feat @ params["w0"]
    e = torch.nn.functional.leaky_relu(
        (z @ params["a0d"])[rows] + (z @ params["a0s"])[cols], 0.2)
    w = torch.exp(e)
    num = torch.zeros_like(z).index_add_(0, rows, w[:, None] * z[cols])
    den = torch.zeros(g.num_nodes).index_add_(0, rows, w)
    for p in params.values():
        p.grad = None
    (num / den.clamp(min=1e-9)[:, None]).square().sum().backward()
    for k in got:
        torch.testing.assert_close(got[k], params[k].grad, rtol=1e-4,
                                   atol=1e-5)


def test_cuda_training_needs_backward_schedule():
    g = j_csr.random_power_law(60, 3.0, seed=0)
    tcfg = t_gnn.GNNConfig(arch="gcn", in_dim=4, hidden_dim=4, num_classes=2,
                           backend="torch", device="cpu")
    m = t_gnn.build_gnn(g, tcfg, reorder="off",
                        config=AggConfig(gs=4, gpt=8, dt=8, src_win=64))
    assert m.plan.partition_bwd is None          # torch: native autograd
    from repro_torch.optim.adamw import AdamWConfig
    with pytest.raises(ValueError, match="with_backward"):
        t_gnn.make_gnn_train_step(
            dataclasses.replace(m, cfg=dataclasses.replace(tcfg,
                                                           backend="cuda")),
            AdamWConfig())
