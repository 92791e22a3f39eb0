"""Port aggregation parity: `repro_torch.kernels.ops.aggregate` (plain
PyTorch version, on the CPU) against `repro.kernels.ops.aggregate` on the
reference's XLA lowering and on its Pallas kernel in interpret mode, for
every gather variant.

Tolerances: float32 output at rtol/atol 1e-5 (summation order differs);
bfloat16-policy output within one bf16 ulp (rtol 2**-7), with edge values
exactly representable in bf16 so the reference's one-hot kernels (which
round their gather matrix to the feature dtype) compute the same sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.csr as j_csr
from repro.core.partition import pad_partition_tiles
from repro.graphs.subgraph import pad_to_nodes
from repro.kernels import ops as j_ops
from repro.kernels.ref import group_aggregate_ref as j_group_ref

from repro_torch.core.partition import partition_graph
from repro_torch.kernels import group_aggregate as t_ga
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.ref import group_aggregate_ref, segment_aggregate_ref

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _schedule(padded: bool, gs=4, gpt=8, src_win=64, seed=3):
    """A power-law graph's schedule; ``padded`` appends edge-less nodes
    (unvisited node blocks) and pow2-pads the tile count."""
    g = j_csr.random_power_law(200, 4.0, seed=seed)
    if padded:
        g = pad_to_nodes(g, 256)
    ev = (np.random.default_rng(seed).integers(1, 9, g.num_edges) / 8.0
          ).astype(np.float32)       # exact in bf16
    p = partition_graph(g, gs=gs, gpt=gpt, ont=8, src_win=src_win,
                        edge_vals=ev)
    if padded:
        p = pad_partition_tiles(p, 1 << p.num_tiles.bit_length())
        assert not p.block_visited().all()
    return g, p


def _run_both(p, d, dtype, dynamic, *, backend, variant="folded", dt=128,
              seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((p.num_nodes, d)).astype(np.float32)
    ev = ((rng.integers(1, 17, p.num_edges) / 16.0).astype(np.float32)
          if dynamic else None)
    out_dtype = None if dtype == "float32" else dtype
    j_out = j_ops.aggregate(
        jnp.asarray(feat, JDT[dtype]), j_ops.DeviceSchedule(p), dt=dt,
        backend=backend, variant=variant,
        edge_values=None if ev is None else jnp.asarray(ev),
        out_dtype=None if out_dtype is None else JDT[out_dtype])
    t_out = t_ops.aggregate(
        torch.from_numpy(feat).to(TDT[dtype]), t_ops.DeviceSchedule(p, "cpu"),
        dt=dt, backend="torch", variant=variant,
        edge_values=None if ev is None else torch.from_numpy(ev),
        out_dtype=None if out_dtype is None else TDT[out_dtype])
    assert t_out.dtype == TDT[dtype] and tuple(t_out.shape) == (p.num_nodes, d)
    return (np.asarray(j_out.astype(jnp.float32)), t_out.float().numpy(),
            F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("d", [1, 3, 16, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_matches_reference_xla(d, dtype, dynamic):
    _, p = _schedule(padded=dynamic)
    j, t, tol = _run_both(p, d, dtype, dynamic, backend="xla")
    np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("variant", ["folded", "slot_onehot", "direct"])
@pytest.mark.parametrize("d,dtype,dynamic,padded", [
    (16, "float32", False, True),      # unvisited blocks, pow2 tiles
    (3, "bfloat16", True, False),
    (130, "float32", True, True),      # two dim tiles
])
def test_matches_reference_pallas_interpret(variant, d, dtype, dynamic,
                                            padded):
    _, p = _schedule(padded=padded)
    j, t, tol = _run_both(p, d, dtype, dynamic, backend="pallas_interpret",
                          variant=variant)
    np.testing.assert_allclose(t, j, **tol)


def test_unvisited_blocks_are_exact_zeros():
    g, p = _schedule(padded=True)
    feat = torch.randn(p.num_nodes, 5)
    out = t_ops.aggregate(feat, t_ops.DeviceSchedule(p, "cpu"),
                          backend="torch")
    assert (out[g.num_nodes - 56:] == 0).all()        # edge-less pad rows


def test_ref_oracles_match_reference():
    _, p = _schedule(padded=False)
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((p.padded_src_rows, 7)).astype(np.float32)
    j = np.asarray(j_group_ref(jnp.asarray(feat), p.nbrs, p.edge_val,
                               p.local_node, p.tile_node_block, p.ont,
                               p.padded_out_rows))
    t = group_aggregate_ref(torch.from_numpy(feat),
                            torch.from_numpy(p.nbrs),
                            torch.from_numpy(p.edge_val),
                            torch.from_numpy(p.local_node),
                            torch.from_numpy(p.tile_node_block), p.ont,
                            p.padded_out_rows).numpy()
    np.testing.assert_allclose(t, j, **F32_TOL)
    # the segment oracle over the CSR computes the same function
    src = p.nbrs.reshape(-1)
    dst = (p.tile_node_block[:, None] * p.ont + p.local_node).repeat(
        p.gs).reshape(-1)
    s = segment_aggregate_ref(torch.from_numpy(feat), torch.from_numpy(src),
                              torch.from_numpy(dst),
                              torch.from_numpy(p.edge_val.reshape(-1)),
                              p.padded_out_rows).numpy()
    np.testing.assert_allclose(s, t, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_dim_tile_matches_reference(dtype):
    for dt in (1, 8, 64, 100, 128, 512):
        for d in (1, 3, 16, 100, 130, 500):
            assert t_ops.dim_tile(dt, d, dtype) == j_ops.dim_tile(
                dt, d, np.dtype(jnp.dtype(dtype))), (dt, d)
            assert t_ops.dim_tile(dt, d, getattr(torch, dtype)) == \
                t_ops.dim_tile(dt, d, dtype)


def test_cuda_backend_rejects_cpu_tensors():
    _, p = _schedule(padded=False)
    with pytest.raises(ValueError, match="CUDA"):
        t_ops.aggregate(torch.randn(p.num_nodes, 4),
                        t_ops.DeviceSchedule(p, "cpu"), backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        t_ops.aggregate(torch.randn(p.num_nodes, 4),
                        t_ops.DeviceSchedule(p, "cpu"), backend="xla")


@pytest.mark.parametrize("variant", ["folded", "slot_onehot", "direct"])
def test_wrapper_routes_cpu_tensors_to_plain_version(variant):
    """The kernel wrapper itself: a CPU tensor runs (and counts) the plain
    version, at the padded geometry `aggregate` hands the kernel."""
    _, p = _schedule(padded=True)
    s = t_ops.DeviceSchedule(p, "cpu")
    feat = torch.randn(p.padded_src_rows, 16)
    before = dict(t_ga.launches)
    out = t_ga.group_aggregate(
        feat, s.nbrs, s.edge_val, s.local_node, s.tile_node_block,
        s.tile_window, s.run_start, gs=s.gs, gpt=s.gpt, ont=s.ont,
        src_win=s.src_win, dt=16, out_rows=s.padded_out_rows,
        variant=variant)
    assert t_ga.launches[t_ga.PLAIN] == before[t_ga.PLAIN] + 1
    assert all(t_ga.launches[k] == before[k]
               for k in t_ga.KERNEL_OF_VARIANT.values())
    ref = group_aggregate_ref(feat, s.nbrs, s.edge_val, s.local_node,
                              s.tile_node_block, s.ont, s.padded_out_rows)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="variant"):
        t_ga.group_aggregate(
            feat, s.nbrs, s.edge_val, s.local_node, s.tile_node_block,
            s.tile_window, s.run_start, gs=s.gs, gpt=s.gpt, ont=s.ont,
            src_win=s.src_win, dt=16, out_rows=s.padded_out_rows,
            variant="bogus")
