"""Port attention parity: `repro_torch.nn.attention` / `repro_torch.nn.flash`
against `repro.nn.attention` / `repro.nn.flash` on the same numpy inputs
(float32, seeded).

Tolerance 1e-5 (float32 rounding apart: the two frameworks sum the same
products in other orders, and their cos / sin / exp / pow differ in the
last bits): elementwise ``max|a-b| / (1 + |b|)`` for the kernels of the
layer (rope, blockwise and flash attention, decode attention) on O(1)
inputs; ``max|a-b| / (1 + max|b|)`` for the whole layer
(`attention_forward`, `attention_decode`), whose random projections
reach O(10) and whose sums of such products cancel to near zero in some
entries.  The 80-step decode runs the same cache on both sides and
checks every step's output and the final cache."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as j_attn
from repro.nn import flash as j_flash
from repro.nn.layers import Initializer as JInit

from repro_torch.nn import attention as t_attn
from repro_torch.nn import flash as t_flash

TOL = 1e-5


def _err(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def _nerr(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ap(**kw):
    base = dict(n_heads=4, n_kv=2, head_dim=16)
    base.update(kw)
    return (j_attn.AttnParams(**base),
            t_attn.AttnParams(**base))


def _params(ap_j, d_model, seed):
    """Reference init, non-zero biases and norm gains, on both sides."""
    p, _ = j_attn.attention_init(JInit(jax.random.PRNGKey(seed)), d_model,
                                 ap_j)
    rng = np.random.default_rng(seed + 100)
    p = {k: (np.asarray(v) if k.startswith("w")
             else _np(rng, *v.shape, scale=0.3)) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.tensor(v) for k, v in p.items()})


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 48, 4, 32)
    pos = np.stack([np.arange(48), np.arange(48) + 7]).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        want = j_attn.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
        got = t_attn.rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=theta)
        assert got.dtype == torch.float32 and _err(got, want) <= TOL


def test_m_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 40, 4, 16)
    pos3 = rng.integers(0, 64, (2, 3, 40)).astype(np.int32)
    want = j_attn.m_rope(jnp.asarray(x), jnp.asarray(pos3), (2, 3, 3),
                         theta=1e6)
    got = t_attn.m_rope(torch.from_numpy(x), torch.from_numpy(pos3),
                        (2, 3, 3), theta=1e6)
    assert _err(got, want) <= TOL
    with pytest.raises(ValueError, match="sections"):
        t_attn.m_rope(torch.from_numpy(x), torch.from_numpy(pos3), (2, 3, 4))


@pytest.mark.parametrize("mode", ["flash", "masked_full", "triangle"])
@pytest.mark.parametrize("window,softcap", [(None, None), (None, 50.0),
                                            (8, None), (32, 30.0)])
def test_blockwise_attention_matches_reference(mode, window, softcap):
    """S 128 at 32-token chunks: windows 8 and 32 take the banded
    branches (window + chunk < S); GQA 4 query heads over 2 kv heads."""
    rng = np.random.default_rng(2)
    B, S, H, K, hd = 2, 128, 4, 2, 16
    q, k, v = _np(rng, B, S, H, hd), _np(rng, B, S, K, hd), \
        _np(rng, B, S, K, hd)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(window=window, softcap=softcap, scale=0.3, q_chunk=32,
              kv_chunk=32, causal_mode=mode)
    want = j_attn.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), **kw)
    got = t_attn.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    assert _err(got, want) <= TOL


def test_blockwise_attention_refuses_ragged_chunks_and_unknown_modes():
    q = torch.zeros(1, 48, 2, 8)
    pos = torch.arange(48)
    for mode in ("flash", "masked_full"):
        with pytest.raises(ValueError, match="multiple of the query"):
            t_attn.blockwise_attention(q, q, q, q_pos=pos, kv_pos=pos,
                                       q_chunk=32, kv_chunk=32,
                                       causal_mode=mode)
    with pytest.raises(ValueError, match="causal_mode"):
        t_attn.blockwise_attention(q, q, q, q_pos=pos, kv_pos=pos,
                                   causal_mode="dense")


@pytest.mark.parametrize("window", [None, 8])
def test_flash_forward_and_lse_match_reference(window):
    rng = np.random.default_rng(3)
    q, k, v = (_np(rng, 2, 64, 2, 16) for _ in range(3))
    pos = np.arange(64, dtype=np.int32)
    jc = j_flash.FlashCfg(scale=0.25, softcap=20.0, window=window, qc=16,
                          kc=16)
    tc = t_flash.FlashCfg(**dataclasses.asdict(jc))
    w_out, w_lse = j_flash._fwd_impl(jc, *(jnp.asarray(a) for a in
                                           (q, k, v, pos, pos)))
    g_out, g_lse = t_flash._fwd_impl(tc, *(torch.from_numpy(a) for a in
                                           (q, k, v, pos, pos)))
    assert _err(g_out, w_out) <= TOL and _err(g_lse, w_lse) <= TOL


FLASH_GRAD_CASES = [   # (window, softcap, q_chunk, kv_chunk)
    (None, None, 16, 16), (None, 20.0, 16, 32), (8, None, 16, 16),
    (8, 20.0, 32, 16), (40, None, 16, 16)]


def _flash_grad_inputs(seed=5, B=2, S=64, H=2, hd=16):
    rng = np.random.default_rng(seed)
    return [_np(rng, B, S, H, hd) for _ in range(4)], np.arange(
        S, dtype=np.int32)


@pytest.mark.parametrize("window,softcap,qc,kc", FLASH_GRAD_CASES)
def test_flash_backward_matches_reference_vjp(window, softcap, qc, kc):
    """Cotangents of q, k, v against the reference's custom VJP, causal,
    windowed (window 8 takes the banded forward at S 64) and softcapped,
    over several query / key chunks."""
    (q, k, v, g), pos = _flash_grad_inputs()
    kw = dict(scale=0.25, softcap=softcap, window=window, q_chunk=qc,
              kv_chunk=kc)
    jpos = jnp.asarray(pos)
    out, vjp = jax.vjp(lambda a, b, c: j_flash.flash_attention(
        a, b, c, q_pos=jpos, kv_pos=jpos, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    got_out = t_flash.flash_attention(tq, tk, tv, q_pos=tpos, kv_pos=tpos,
                                      **kw)
    assert _nerr(got_out, out) <= TOL
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and _nerr(a, b) <= TOL


@pytest.mark.parametrize("window,softcap,qc,kc", FLASH_GRAD_CASES)
def test_flash_backward_matches_masked_full_autograd(window, softcap, qc,
                                                     kc):
    """The hand-written backward against plain autograd through
    ``causal_mode="masked_full"`` (GQA: k / v with half the heads)."""
    (q, k, v, g), pos = _flash_grad_inputs(seed=6, H=4)
    k, v = k[:, :, :2], v[:, :, :2]
    tpos = torch.from_numpy(pos)
    grads = []
    for mode in ("flash", "masked_full"):
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = t_attn.blockwise_attention(
            *ins, q_pos=tpos, kv_pos=tpos, window=window, softcap=softcap,
            scale=0.25, q_chunk=qc, kv_chunk=kc, causal_mode=mode)
        grads.append(torch.autograd.grad(out, ins, torch.from_numpy(g)))
    for a, b in zip(*grads):
        assert _nerr(a, b.numpy()) <= TOL


def test_flash_backward_returns_the_inputs_dtypes():
    (q, k, v, g), pos = _flash_grad_inputs(seed=7)
    ins = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
           for a in (q, k, v)]
    tpos = torch.from_numpy(pos)
    out = t_flash.flash_attention(*ins, q_pos=tpos, kv_pos=tpos,
                                  q_chunk=16, kv_chunk=16)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    assert all(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
               for a in got)


@pytest.mark.parametrize("layout", [
    dict(fused_qkv=True), dict(fused_qkv=False),
    dict(fused_qkv=True, bias=True), dict(fused_qkv=False, qk_norm=True),
    dict(fused_qkv=False, bias=True, qk_norm=True, rope="mrope",
         mrope_sections=(2, 3, 3), softcap=50.0, window=8),
    dict(fused_qkv=True, rope="none", query_scale=0.2)])
def test_attention_forward_matches_reference(layout):
    rng = np.random.default_rng(4)
    ap_j, ap_t = _ap(**layout)
    pj, pt = _params(ap_j, 32, seed=5)
    x = _np(rng, 2, 64, 32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    if ap_j.rope == "mrope":
        pos = np.broadcast_to(pos[:, None], (2, 3, 64))
    pos = np.ascontiguousarray(pos)
    want, (wk, wv) = j_attn.attention_forward(
        pj, ap_j, jnp.asarray(x), jnp.asarray(pos), q_chunk=16, kv_chunk=16,
        causal_mode="flash", return_kv=True)
    got, (gk, gv) = t_attn.attention_forward(
        pt, ap_t, torch.from_numpy(x), torch.from_numpy(pos), q_chunk=16,
        kv_chunk=16, causal_mode="flash", return_kv=True)
    assert got.shape == (2, 64, 32) and gk.shape == (2, 64, 2, 16)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert _nerr(g, w) <= TOL


def test_attention_init_shapes_and_fan_in():
    """Same keys and shapes as the reference; the reference's fan-in rule
    (shape[-2]): wqkv (d, H+2K, hd) at 1/sqrt(H+2K), wo at 1/sqrt(hd)."""
    from repro_torch.nn.layers import Initializer
    for layout in (dict(fused_qkv=True, bias=True),
                   dict(fused_qkv=False, qk_norm=True)):
        ap_j, ap_t = _ap(n_heads=32, n_kv=8, head_dim=128, **layout)
        jp, _ = j_attn.attention_init(JInit(jax.random.PRNGKey(0)), 256, ap_j)
        init = Initializer(torch.Generator().manual_seed(0), device="cpu")
        tp = t_attn.attention_init(init, 256, ap_t)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: v.shape for k, v in jp.items()}
        for name in ("wqkv", "wq", "wo"):
            if name in tp:
                fan_in = tp[name].shape[-2]
                assert abs(float(tp[name].std()) * fan_in ** 0.5 - 1) < 0.05


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(6)
    q = _np(rng, 2, 1, 4, 16)
    ck, cv = _np(rng, 2, 24, 2, 16), _np(rng, 2, 24, 2, 16)
    kv_pos = np.where(np.arange(24) < 20, np.arange(24), -1).astype(np.int32)
    for window, softcap in ((None, None), (6, 50.0)):
        kw = dict(scale=0.25, softcap=softcap, window=window)
        want = j_attn.decode_attention(
            *(jnp.asarray(a) for a in (q, ck, cv, kv_pos)), 17, **kw)
        got = t_attn.decode_attention(
            *(torch.from_numpy(a) for a in (q, ck, cv, kv_pos)), 17, **kw)
        assert got.shape == (2, 1, 4, 16) and _err(got, want) <= TOL


@pytest.mark.parametrize("window", [None, 32])
def test_attention_decode_over_80_steps(window):
    """80 steps into a cache of max_seq 80: a window of 32 keeps a
    32-slot ring, which wraps twice; every step's output and the final
    cache match the reference's."""
    rng = np.random.default_rng(7)
    ap_j, ap_t = _ap(window=window, softcap=50.0, bias=True, qk_norm=True)
    pj, pt = _params(ap_j, 32, seed=8)
    steps = 80
    jc = j_attn.init_cache(2, ap_j, steps, dtype=jnp.float32)
    tc = t_attn.init_cache(2, ap_t, steps, dtype=torch.float32,
                           device="cpu")
    assert tc["k"].shape == jc["k"].shape == \
        (2, 32 if window else steps, 2, 16)
    j_step = jax.jit(lambda p, x, c, t, pos: j_attn.attention_decode(
        p, ap_j, x, c, t, pos))
    xs = _np(rng, steps, 2, 1, 32)
    worst = 0.0
    for t in range(steps):
        pos = np.full((2, 1), t, np.int32)
        want, jc = j_step(pj, jnp.asarray(xs[t]), jc, jnp.int32(t),
                          jnp.asarray(pos))
        got, tc = t_attn.attention_decode(pt, ap_t, torch.from_numpy(xs[t]),
                                          tc, t, torch.from_numpy(pos))
        worst = max(worst, _nerr(got, want))
    assert worst <= TOL
    for key in ("k", "v"):
        assert _nerr(tc[key], jc[key]) <= TOL


def test_ring_positions_match_reference_formula():
    for Sc, windowed in ((7, True), (16, False)):
        for t in range(40 if windowed else 16):
            got = t_attn.ring_positions(t, Sc, windowed=windowed, device="cpu")
            idx = np.arange(Sc)
            if windowed:
                want = t - ((t % Sc) - idx) % Sc
                want = np.where(want > t, want - Sc, want)
                want = np.where(want < 0, -1, want)
            else:
                want = np.where(idx <= t, idx, -1)
            np.testing.assert_array_equal(got.numpy(), want)
