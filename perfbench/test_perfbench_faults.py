"""A run with the timed path broken underneath comes out not correct,
once for each fault the cell can have (one card: no exchange between
chips to leave out)."""
import pytest
import torch

from perfbench._testing import INFER, TRAIN, run_small


def _unchanged_state(monkeypatch):
    import repro_torch.optim.adamw as adamw

    def update(cfg, grads, state, params, **kw):
        return params, state, {"grad_norm": adamw.global_norm(grads),
                               "lr": torch.tensor(cfg.lr)}
    monkeypatch.setattr(adamw, "adamw_update", update)


def _update_doubled(monkeypatch):
    """Each step moves the parameters twice as far; its moments are
    right."""
    import repro_torch.optim.adamw as adamw
    real = adamw.adamw_update

    def update(cfg, grads, state, params, **kw):
        new, state, met = real(cfg, grads, state, params, **kw)
        return {k: p + 2.0 * (new[k] - p) for k, p in params.items()}, \
            state, met
    monkeypatch.setattr(adamw, "adamw_update", update)


def _half_batch(monkeypatch):
    import repro_torch.models.gnn as gnn
    real = gnn._masked_xent

    def xent(lg, labels, mask=None):
        keep = (torch.arange(lg.shape[0]) % 2 == 0).to(lg.device)
        return real(lg, labels, mask * keep)
    monkeypatch.setattr(gnn, "_masked_xent", xent)


def _logits_patch(monkeypatch, alter):
    from repro_torch.models.gnn import GNNModel
    real = GNNModel.logits

    def logits(self, params, feat):
        return alter(real(self, params, feat).clone())
    monkeypatch.setattr(GNNModel, "logits", logits)


def _answer_altered(monkeypatch):
    def alter(lg):
        top = lg[7].topk(2).indices            # node 7 answers its second
        lg[7, top[0]], lg[7, top[1]] = lg[7, top[1]], lg[7, top[0]]
        return lg
    _logits_patch(monkeypatch, alter)


def _half_nodes(monkeypatch):
    def alter(lg):
        lg[::2] = 0
        return lg
    _logits_patch(monkeypatch, alter)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in TRAIN
    for f in (_unchanged_state, _update_doubled, _half_batch)] + [
    (w, f) for w in INFER for f in (_answer_altered, _half_nodes)],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run_small(workload)
    assert not out["correct"], out["checks"]
