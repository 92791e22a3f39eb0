"""Port parity of the LM training substrate: `repro_torch.data`,
`repro_torch.nn.losses`, `repro_torch.distributed.accumulate` and the
tree form of `repro_torch.optim.adamw`, against their `repro.*`
counterparts on the same numpy inputs.

The data pipeline is numpy on both sides: bit-equal.  The losses and
gradients are float32; tolerance ``max|a-b| / (1 + max|b|) <= 1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as j_pipe
from repro.distributed import accumulate as j_acc
from repro.nn import losses as j_losses
from repro.optim import adamw as j_adamw

from repro_torch.data import pipeline as t_pipe
from repro_torch.distributed import accumulate as t_acc
from repro_torch.nn import losses as t_losses
from repro_torch.optim import adamw as t_adamw

TOL = 1e-5


def _nerr(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,hosts,seed", [
    (256, 64, 8, 1, 0), (32_000, 33, 6, 2, 3), (100, 16, 4, 4, 7)])
def test_token_pipeline_matches_reference_bit_for_bit(vocab, seq, batch,
                                                      hosts, seed):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch,
                  num_hosts=hosts, host_id=host, seed=seed)
        jp = j_pipe.TokenPipeline(j_pipe.PipelineConfig(**kw))
        tp = t_pipe.TokenPipeline(t_pipe.PipelineConfig(**kw))
        for step in (0, 1, 17):
            want, got = jp.batch(step), tp.batch(step)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(next(iter(tp)), jp.batch(0))


@pytest.mark.parametrize("frontend,mrope", [("tokens", False),
                                            ("tokens", True),
                                            ("embeds", False)])
def test_make_lm_batch_matches_reference_bit_for_bit(frontend, mrope):
    toks = j_pipe.TokenPipeline(j_pipe.PipelineConfig(
        vocab=512, seq_len=24, global_batch=4, seed=1)).batch(3)
    kw = dict(frontend=frontend, d_model=16, mrope=mrope, seed=5)
    want, got = j_pipe.make_lm_batch(toks, **kw), t_pipe.make_lm_batch(
        toks, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    assert got["pos"].shape == ((4, 3, 24) if mrope else (4, 24))


def test_pipeline_refuses_a_batch_that_does_not_split_over_hosts():
    with pytest.raises(ValueError, match="multiple of 3 hosts"):
        t_pipe.TokenPipeline(t_pipe.PipelineConfig(
            vocab=8, seq_len=4, global_batch=4, num_hosts=3))


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

B, S, D, V = 2, 60, 16, 96


def _xent_inputs(seed=0, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = ((rng.random((B, S)) > 0.3).astype(np.float32) if masked
            else None)
    return x, w, labels, mask


def _port_xent(fn, x, w, labels, mask, **kw):
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss, metrics = fn(tx, tw, torch.from_numpy(labels),
                       mask=None if mask is None else torch.from_numpy(mask),
                       **kw)
    return loss, metrics, torch.autograd.grad(loss, (tx, tw))


# chunk 20 divides S = 60; 16 does not (the chunk falls to 15)
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [20, 16])
def test_chunked_xent_matches_reference_loss_and_gradients(softcap, z_loss,
                                                           masked, chunk):
    x, w, labels, mask = _xent_inputs(seed=1, masked=masked)
    kw = dict(chunk=chunk, z_loss=z_loss, logit_softcap=softcap)

    def ref(jx, jw):
        return j_losses.chunked_softmax_xent(
            jx, jw, jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask), **kw)

    (j_loss, j_m), (j_dx, j_dw) = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    loss, metrics, (dx, dw) = _port_xent(t_losses.chunked_softmax_xent,
                                         x, w, labels, mask, **kw)
    assert _nerr(loss, j_loss) <= TOL
    assert _nerr(dx, j_dx) <= TOL and _nerr(dw, j_dw) <= TOL
    assert dx.dtype == dw.dtype == torch.float32
    for k in ("xent", "accuracy", "tokens"):
        assert _nerr(metrics[k], j_m[k]) <= TOL, k


@pytest.mark.parametrize("softcap,z_loss,masked", [(None, 0.0, False),
                                                   (30.0, 1e-4, True)])
def test_dense_xent_matches_reference_and_the_chunked_port(softcap, z_loss,
                                                           masked):
    x, w, labels, mask = _xent_inputs(seed=2, masked=masked)
    kw = dict(z_loss=z_loss, logit_softcap=softcap)
    (j_loss, j_m), (j_dx, j_dw) = jax.value_and_grad(
        lambda a, b: j_losses.softmax_xent_dense(
            a, b, jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask), **kw),
        argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    d_loss, d_m, (d_dx, d_dw) = _port_xent(t_losses.softmax_xent_dense,
                                           x, w, labels, mask, **kw)
    c_loss, c_m, (c_dx, c_dw) = _port_xent(t_losses.chunked_softmax_xent,
                                           x, w, labels, mask, chunk=12,
                                           **kw)
    assert _nerr(d_loss, j_loss) <= TOL
    assert _nerr(d_dx, j_dx) <= TOL and _nerr(d_dw, j_dw) <= TOL
    assert _nerr(c_loss, d_loss.detach()) <= TOL
    assert _nerr(c_dx, d_dx) <= TOL and _nerr(c_dw, d_dw) <= TOL
    for k in ("xent", "accuracy", "tokens"):
        assert _nerr(d_m[k], j_m[k]) <= TOL
        assert _nerr(c_m[k], d_m[k].detach()) <= TOL


def test_chunked_xent_in_bfloat16_returns_bfloat16_gradients():
    x, w, labels, _ = _xent_inputs(seed=3)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, w))
    loss, _ = t_losses.chunked_softmax_xent(tx, tw, torch.from_numpy(labels),
                                            chunk=20)
    dx, dw = torch.autograd.grad(loss, (tx, tw))
    assert loss.dtype == torch.float32
    assert dx.dtype == dw.dtype == torch.bfloat16


def _largest_saved(fn) -> int:
    """The largest tensor autograd saves while ``fn`` runs (elements)."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return max(sizes)


def test_chunked_xent_saves_no_logits_tensor():
    """Autograd keeps nothing of B*S*V elements for the chunked loss (the
    dense loss, the probe's control, does); a chunk is B*c*V."""
    x, w, labels, _ = _xent_inputs(seed=4)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tl = torch.from_numpy(labels)
    chunked = _largest_saved(lambda: t_losses.chunked_softmax_xent(
        tx, tw, tl, chunk=20))
    dense = _largest_saved(lambda: t_losses.softmax_xent_dense(tx, tw, tl))
    assert dense >= B * S * V
    assert chunked < B * S * V and chunked == max(B * S * D, D * V)


# ---------------------------------------------------------------------------
# micro-batching
# ---------------------------------------------------------------------------

def _toy(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 5)).astype(np.float32),
             "y": rng.standard_normal((8, 3)).astype(np.float32)}
    return params, batch


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_accumulate_gradients_matches_reference(n_micro):
    params, batch = _toy()

    def j_loss(p, mb):
        err = jnp.tanh(mb["x"] @ p["w"] + p["b"]) - mb["y"]
        loss = jnp.mean(err ** 2)
        return loss, {"loss": loss, "abs": jnp.mean(jnp.abs(err))}

    def t_loss(p, mb):
        err = torch.tanh(mb["x"] @ p["w"] + p["b"]) - mb["y"]
        loss = torch.mean(err ** 2)
        return loss, {"loss": loss, "abs": torch.mean(torch.abs(err))}

    jg, jl, jm = j_acc.accumulate_gradients(
        j_loss, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch), n_micro)
    tg, tl, tm = t_acc.accumulate_gradients(
        t_loss, {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, n_micro)
    assert _nerr(tl, jl) <= TOL
    assert all(_nerr(tm[k], jm[k]) <= TOL for k in jm)
    assert all(_nerr(tg[k], jg[k]) <= TOL and tg[k].dtype == torch.float32
               for k in jg)
    assert not any(v.requires_grad for v in tg.values())


def test_split_batch_views_and_refusal():
    batch = {"a": torch.arange(12).reshape(6, 2), "b": torch.arange(6)}
    parts = t_acc.split_batch(batch, 3)
    assert [p["b"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert parts[2]["a"].tolist() == [[8, 9], [10, 11]]
    with pytest.raises(ValueError, match="4 micro-batches"):
        t_acc.split_batch(batch, 4)


# ---------------------------------------------------------------------------
# AdamW over parameter trees
# ---------------------------------------------------------------------------

def _tree(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)
    return {"embed": r(6, 4), "final_norm": {"g": r(4)},
            "blocks": [({"w": r(4, 4), "g": r(4)}, {"b": r(3)})
                       for _ in range(2)]}


def _stack_np(tree):
    """The reference's layout of `_tree`: blocks stacked on (R,)."""
    n = lambda t: t.float().numpy()
    return {"embed": n(tree["embed"]), "final_norm": {"g": n(
        tree["final_norm"]["g"])},
        "blocks": tuple({k: np.stack([n(rep[s][k]) for rep in tree["blocks"]])
                         for k in tree["blocks"][0][s]} for s in range(2))}


def test_adamw_on_a_nested_tree_matches_reference_with_stacked_decay():
    """Two steps on an LM-shaped tree against the reference on its stacked
    layout: with ``decay`` set the port's 1-D block leaves decay as the
    reference's stacked 2-D ones do; ``final_norm`` does not."""
    from repro_torch.models.lm import weight_decay_mask
    p, g1, g2 = _tree(0), _tree(1), _tree(2)
    cfg_kw = dict(lr=1e-2, weight_decay=0.5, grad_clip=1.0)
    jcfg = j_adamw.AdamWConfig(**cfg_kw,
                               schedule=j_adamw.cosine_schedule(1, 4))
    tcfg = t_adamw.AdamWConfig(**cfg_kw,
                               schedule=t_adamw.cosine_schedule(1, 4))
    jp = jax.tree.map(jnp.asarray, _stack_np(p))
    js = j_adamw.adamw_init(jp)
    ts = t_adamw.adamw_init(p)
    decay = weight_decay_mask(p)
    assert decay["blocks"][1][0]["g"] is True
    assert decay["final_norm"]["g"] is False
    for g in (g1, g2):
        jp, js, jm = j_adamw.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, _stack_np(g)), js, jp)
        p, ts, tm = t_adamw.adamw_update(tcfg, g, ts, p, decay=decay)
        for a, b in zip(jax.tree.leaves(_stack_np(p)), jax.tree.leaves(jp)):
            assert _nerr(a, b) <= TOL
        for a, b in zip(jax.tree.leaves(_stack_np(ts.m)), jax.tree.leaves(
                js.m)):
            assert _nerr(a, b) <= TOL
        assert _nerr(tm["grad_norm"], jm["grad_norm"]) <= TOL
    # the default rule (ndim >= 2 on the port's own leaves) leaves the 1-D
    # block leaves undecayed, and they part from the reference
    p0 = _tree(0)
    j0 = jax.tree.map(jnp.asarray, _stack_np(p0))
    jp1, _, _ = j_adamw.adamw_update(
        jcfg, jax.tree.map(jnp.asarray, _stack_np(g1)),
        j_adamw.adamw_init(j0), j0)
    q, _, _ = t_adamw.adamw_update(tcfg, g1, t_adamw.adamw_init(p0), p0)
    assert _nerr(_stack_np(q)["blocks"][0]["g"], jp1["blocks"][0]["g"]) > TOL
    assert _nerr(_stack_np(q)["embed"], jp1["embed"]) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_place_equals_out_of_place(dtype):
    cfg = t_adamw.AdamWConfig(lr=3e-3, schedule=t_adamw.cosine_schedule(2, 5))
    p_out, p_in = _tree(0, dtype), _tree(0, dtype)
    s_out, s_in = t_adamw.adamw_init(p_out), t_adamw.adamw_init(p_in)
    leaves_in = t_adamw._leaves(p_in) + t_adamw._leaves(s_in.m)
    for seed in (1, 2, 3):
        g = _tree(seed, dtype)
        p_out, s_out, m_out = t_adamw.adamw_update(cfg, g, s_out, p_out)
        q, s_in, m_in = t_adamw.adamw_update_(cfg, g, s_in, p_in)
        assert q is p_in
    got = t_adamw._leaves(p_in) + t_adamw._leaves(s_in.m)
    assert all(a is b for a, b in zip(got, leaves_in))
    for a, b in zip(got + t_adamw._leaves(s_in.v),
                    t_adamw._leaves(p_out) + t_adamw._leaves(s_out.m)
                    + t_adamw._leaves(s_out.v)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(s_in.step) == int(s_out.step) == 3
    assert torch.equal(m_in["grad_norm"], m_out["grad_norm"])
