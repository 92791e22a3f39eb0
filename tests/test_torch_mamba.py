"""Port Mamba parity: the selective-scan oracle and wrapper
(`repro_torch.kernels.ref` / `kernels.selective_scan`) and the Mamba-1
block (`repro_torch.nn.mamba`) against `repro.kernels.ref`,
`repro.kernels.selective_scan` (Pallas, interpret mode) and
`repro.nn.mamba`, on the same numpy-made inputs and carried weights.

Tolerances: the port's per-token oracle vs the reference's at
atol=rtol=1e-5 (the same recurrence; exp / log1p differ by float32
rounding between the frameworks); vs the Pallas kernel and the chunked
paths at the reference tests' own 1e-4 (associative-scan order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.ref import selective_scan_ref as j_scan_ref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.nn import mamba as j_mamba
from repro.nn.layers import Initializer as JInitializer

from repro_torch.kernels import selective_scan as t_scan
from repro_torch.kernels.ref import selective_scan_ref, softplus
from repro_torch.nn import mamba as t_mamba
from repro_torch.nn.layers import Initializer

REF_TOL = dict(atol=1e-5, rtol=1e-5)
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = [(2, 32, 16, 4, 8, 8), (1, 64, 32, 8, 16, 16),
          (2, 64, 48, 16, 32, 24), (3, 40, 20, 4, 10, 20)]


def _inputs(rng, B, S, di, N):
    """numpy float32 operands, as `tests/test_selective_scan.py:_inputs`."""
    return (rng.standard_normal((B, S, di)).astype(np.float32),
            (rng.standard_normal((B, S, di)) * 0.5 - 1.0).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            np.log(rng.uniform(0.5, 4.0, (di, N))).astype(np.float32),
            (rng.standard_normal(di) * 0.1).astype(np.float32),
            rng.standard_normal(di).astype(np.float32))


def _t(args):
    return [torch.from_numpy(a) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("B,S,di,N,ch,dtw", SHAPES)
def test_scan_ref_matches_reference_oracle(B, S, di, N, ch, dtw):
    args = _inputs(np.random.default_rng(B * 1000 + S), B, S, di, N)
    got = selective_scan_ref(*_t(args))
    assert got.dtype == torch.float32 and got.shape == (B, S, di)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_scan_ref(*_j(args))),
                               **REF_TOL)


@pytest.mark.parametrize("B,S,di,N,ch,dtw", SHAPES)
def test_scan_ref_matches_pallas_interpret(B, S, di, N, ch, dtw):
    """The reference kernel at its own (chunk, dt_width) tilings: the
    port's result does not depend on them."""
    args = _inputs(np.random.default_rng(B * 1000 + S), B, S, di, N)
    want = selective_scan_pallas(*_j(args), chunk=ch, dt_width=dtw,
                                 interpret=True)
    got = t_scan.selective_scan(*_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@settings(max_examples=4, deadline=None)
@given(B=st.integers(1, 3), nc=st.integers(1, 4), nd=st.integers(1, 3),
       N=st.sampled_from([2, 4, 8]), seed=st.integers(0, 999))
def test_scan_property_against_pallas(B, nc, nd, N, seed):
    ch, dtw = 8, 8
    S, di = nc * ch, nd * dtw
    args = _inputs(np.random.default_rng(seed), B, S, di, N)
    want = selective_scan_pallas(*_j(args), chunk=ch, dt_width=dtw,
                                 interpret=True)
    got = selective_scan_ref(*_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


def test_softplus_is_jax_softplus_above_threshold():
    """`torch.nn.functional.softplus` returns x above 20; JAX's does not
    cut over, and the port's follows JAX."""
    x = np.array([-30.0, -3.0, 0.0, 0.5, 19.9, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


def test_wrapper_on_cpu_counts_one_plain_call():
    args = _t(_inputs(np.random.default_rng(0), 2, 16, 8, 4))
    t_scan.reset_launches()
    y = t_scan.selective_scan(*args)
    assert t_scan.launches == {"selective_scan": 0, "selective_scan_ref": 1}
    torch.testing.assert_close(y, selective_scan_ref(*args), rtol=0, atol=0)
    t_scan.reset_launches()
    assert sum(t_scan.launches.values()) == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrapper takes
    its CUDA path: every check before the launch runs, and a refusal
    raises before anything touches CUDA."""

    @property
    def is_cuda(self):
        return True


class _ReachedBuild(Exception):
    pass


def test_scan_wrapper_refuses_past_its_limits_on_the_card(monkeypatch):
    """On the card the scan wrapper refuses, before any launch, more than
    32 states a channel and more than 65,535 batch rows (the grid's y
    extent); at 32 states and 65,535 rows it passes every check and goes
    on to build the kernel."""
    def call(B, N):
        rng = np.random.default_rng(0)
        args = _t(_inputs(rng, B, 1, 4, N))
        args[0] = args[0].as_subclass(_OnCard)
        return t_scan.selective_scan(*args)

    def load(name):
        raise _ReachedBuild(name)

    monkeypatch.setattr(t_scan.build, "load", load)
    assert (t_scan.MAX_STATE, t_scan.MAX_BATCH) == (32, 65535)
    t_scan.reset_launches()
    with pytest.raises(ValueError, match="1..32 states"):
        call(1, 33)
    with pytest.raises(ValueError, match="at most 65535 batch rows"):
        call(65536, 4)
    for B, N in ((1, 32), (65535, 4)):
        with pytest.raises(_ReachedBuild, match="selective_scan"):
            call(B, N)
    assert sum(t_scan.launches.values()) == 0


def test_float64_witness():
    """``acc_dtype=float64`` runs the recurrence in float64: it matches a
    numpy float64 loop to rounding and the float32 oracle to 1e-5."""
    B, S, di, N = 2, 24, 12, 4
    args = _inputs(np.random.default_rng(11), B, S, di, N)
    got = selective_scan_ref(*_t(args), acc_dtype=torch.float64)
    assert got.dtype == torch.float64
    xc, dt_raw, b, c, a_log, dt_bias, d_skip = (a.astype(np.float64)
                                                for a in args)
    a_mat = -np.exp(a_log)
    dt = np.logaddexp(dt_raw + dt_bias, 0.0)
    h = np.zeros((B, di, N))
    want = np.empty((B, S, di))
    for t in range(S):
        h = (np.exp(dt[:, t, :, None] * a_mat) * h
             + (dt[:, t] * xc[:, t])[:, :, None] * b[:, t, None, :])
        want[:, t] = (h * c[:, t, None, :]).sum(-1) + d_skip * xc[:, t]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(selective_scan_ref(*_t(args)).numpy(), want,
                               **REF_TOL)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------

D_MODEL = 16


def _block(mp_kw, seed=0):
    """Reference weights (float32) carried into the port, and an input."""
    mp = j_mamba.MambaParams(**mp_kw)
    p, _ = j_mamba.mamba_init(JInitializer(jax.random.PRNGKey(seed),
                                           dtype=jnp.float32), D_MODEL, mp)
    p_np = {k: np.asarray(v) for k, v in p.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 32, D_MODEL)).astype(np.float32)
    return mp, p, {k: torch.tensor(v) for k, v in p_np.items()}, x


def _port_mp(mp, fused_scan):
    return t_mamba.MambaParams(d_inner=mp.d_inner, d_state=mp.d_state,
                               dt_rank=mp.dt_rank, d_conv=mp.d_conv,
                               chunk=mp.chunk, fused_scan=fused_scan)


def test_mamba_init_shapes_and_s4d_a_log():
    mp = t_mamba.MambaParams(d_inner=32, d_state=8)
    init = Initializer(torch.Generator().manual_seed(0), device="cpu")
    p = t_mamba.mamba_init(init, D_MODEL, mp)
    jp, _ = j_mamba.mamba_init(JInitializer(jax.random.PRNGKey(0),
                                            dtype=jnp.float32), D_MODEL,
                               j_mamba.MambaParams(d_inner=32, d_state=8))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    # log(1..N): the two frameworks' log may differ by one float32 ulp
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2.0 ** -23, atol=0)
    for k in ("conv_b", "dt_bias", "D"):
        assert not p[k].any()


@pytest.mark.parametrize("fused_scan", ["on", "off"])
@pytest.mark.parametrize("j_path", ["interpret", "off"])
def test_mamba_forward_matches_reference(fused_scan, j_path):
    mp, jp, tp, x = _block(dict(d_inner=32, d_state=8, chunk=8))
    want = j_mamba.mamba_forward(
        jp, jnp.asarray(x), dataclasses.replace(mp, pallas_scan=j_path))
    t_scan.reset_launches()
    got = t_mamba.mamba_forward(tp, torch.from_numpy(x),
                                _port_mp(mp, fused_scan), backend="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    # the fused path runs the plain version once, the chunked path never
    assert t_scan.launches == {"selective_scan": 0,
                               "selective_scan_ref": int(fused_scan == "on")}


def test_mamba_forward_cuda_backend_needs_cuda_tensors():
    mp, _, tp, x = _block(dict(d_inner=32, d_state=8, chunk=8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_mamba.mamba_forward(tp, torch.from_numpy(x), _port_mp(mp, "on"),
                              backend="cuda")


def test_mamba_forward_state_carry_matches_reference():
    mp, jp, tp, x = _block(dict(d_inner=32, d_state=8, chunk=8), seed=3)
    j_out, j_h = j_mamba.mamba_forward(jp, jnp.asarray(x[:, :16]), mp,
                                       return_state=True)
    t_out, t_h = t_mamba.mamba_forward(tp, torch.from_numpy(x[:, :16]),
                                       _port_mp(mp, "on"), return_state=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **SCAN_TOL)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **SCAN_TOL)


def test_mamba_forward_rejects_ragged_chunks_on_chunked_path():
    mp, _, tp, x = _block(dict(d_inner=32, d_state=8, chunk=8))
    with pytest.raises(ValueError, match="chunk"):
        t_mamba.mamba_forward(tp, torch.from_numpy(x[:, :12]),
                              _port_mp(mp, "off"))
    # the fused path takes any length
    y = t_mamba.mamba_forward(tp, torch.from_numpy(x[:, :12]),
                              _port_mp(mp, "on"), backend="torch")
    assert y.shape == (2, 12, D_MODEL)


def test_mamba_decode_matches_reference_over_sequence():
    mp, jp, tp, x = _block(dict(d_inner=32, d_state=8, chunk=8), seed=5)
    j_st = j_mamba.init_mamba_state(2, D_MODEL, mp, dtype=jnp.float32)
    t_st = t_mamba.init_mamba_state(2, D_MODEL, _port_mp(mp, "on"),
                                    device="cpu")
    for t in range(x.shape[1]):
        j_y, j_st = j_mamba.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         j_st, mp)
        t_y, t_st = t_mamba.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                         t_st, _port_mp(mp, "on"))
        np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), **SCAN_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(t_st[k].numpy(), np.asarray(j_st[k]),
                                   **SCAN_TOL)


def test_mamba_prefill_matches_decode_recurrence():
    """The port's fused prefill and its own decode loop agree (the
    property the reference's `test_mamba_chunked_matches_recurrence`
    holds)."""
    mp, _, tp, x = _block(dict(d_inner=32, d_state=8, chunk=8), seed=7)
    pmp = _port_mp(mp, "on")
    full = t_mamba.mamba_forward(tp, torch.from_numpy(x), pmp,
                                 backend="torch")
    st = t_mamba.init_mamba_state(2, D_MODEL, pmp, device="cpu")
    steps = []
    for t in range(x.shape[1]):
        y, st = t_mamba.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                     st, pmp)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=1e-4,
                               atol=1e-4)


def test_mamba_params_rejects_unknown_scan_mode():
    with pytest.raises(ValueError, match="fused_scan"):
        t_mamba.MambaParams(d_inner=8, fused_scan="interpret")
    with pytest.raises(ValueError, match="backend"):
        _, _, tp, x = _block(dict(d_inner=32, d_state=8, chunk=8))
        t_mamba.mamba_forward(tp, torch.from_numpy(x),
                              t_mamba.MambaParams(d_inner=32, d_state=8),
                              backend="xla")
