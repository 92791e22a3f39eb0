"""The drivers' sharded paths on the CPU: ``train --shards 2`` (GCN,
GIN), ``train --sampled --shards 2`` (with ``--stream-deltas``) and
``serve_gnn --shards 2 --smoke --stream-deltas 2``, each against the
same driver's single-device run, on gloo ranks (``--device cpu
--backend torch``, where every rank's kernel wrapper runs the plain
version and counts it).

Tolerances, all in ``max|a-b| / (1 + max|b|)``: full-graph losses at
every step and final parameters 1e-4; the sampled step's gradient
against the single-device gradient of the union batch 1e-4; served
answers 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import group_aggregate as ga
from repro_torch.launch import serve_gnn
from repro_torch.launch import train as t_train
from repro_torch.models.gnn import (GNNConfig, gnn_block_logits,
                                    init_gnn_params)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sampling import (LoaderConfig, SampledLoader,
                                  ShardedSampledTrainStep)

CPU = ["--device", "cpu", "--backend", "torch", "--dataset", "cora",
       "--warmup", "1"]


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


@pytest.mark.parametrize("arch,per_step", [("gcn", 4), ("gin", 3)])
def test_train_shards_matches_single_device_run(arch, per_step, tmp_path):
    """``train --shards 2`` from the same seed: every step's loss and the
    final parameters equal the single-device run's (1e-4), and each rank
    ran the aggregation as often a step as a train-ready single-device
    model does on the card (GCN: 2 forward + 2 transposed; GIN: layer
    0's input takes no gradient).  (The single-device CPU run
    differentiates the plain version natively, without a transposed
    schedule, so its own count is not comparable.)"""
    flags = CPU + ["--arch", arch, "--steps", "4"]
    one = t_train.run(flags + ["--ckpt-dir", str(tmp_path / "one")])
    # a failure at step 3 restarts every rank from the step-2 checkpoint
    # the caller wrote
    two = t_train.run(flags + ["--shards", "2", "--ckpt-every", "2",
                               "--fail-at", "3",
                               "--ckpt-dir", str(tmp_path / "two")])
    assert two["trainer"].injector.fired == {3}
    assert two["ok"] and len(two["history"]) == 5
    replayed = two["history"][:3] + two["history"][4:]   # step 2 twice
    assert [m["step"] for m in two["history"]] == [0, 1, 2, 2, 3]
    for a, b in zip(replayed, one["history"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * (1 + abs(b["loss"]))
    p1, p2 = one["trainer"].state[0], two["trainer"].state[0]
    for k in p1:
        assert _nerr(p2[k], p1[k]) <= 1e-4, k
    assert one["rank_launches"] is None
    assert [c[ga.PLAIN] for c in two["rank_launches"]] == [5 * per_step] * 2
    # a rerun in the same directory resumes at the last checkpoint
    again = t_train.run(flags + ["--shards", "2", "--ckpt-every", "2",
                                 "--ckpt-dir", str(tmp_path / "two")])
    assert again["trainer"].step == 8 and again["ok"]


def test_train_sampled_shards(tmp_path):
    """``train --sampled --shards 2 --stream-deltas 2``: finite losses,
    each rank's loader builds its own share (plain launches exact: one a
    layer, the torch backend differentiates natively) and takes the
    streamed delta; then one `ShardedSampledTrainStep` gradient against
    the single-device gradient of the union of batches 2s and 2s+1."""
    flags = CPU + ["--arch", "gcn", "--sampled", "--fanouts", "5,3",
                   "--batch-nodes", "128", "--steps", "4"]
    res = t_train.run(flags + ["--shards", "2", "--stream-deltas", "2",
                               "--ckpt-dir", str(tmp_path / "s")])
    assert res["ok"] and len(res["history"]) == 4
    assert [c[ga.PLAIN] for c in res["rank_launches"]] == [8, 8]
    assert res["stream"].applied_at == [2]
    assert res["stats"]["graph_swaps"] == 1
    assert res["stats"]["batches_built"] >= 4

    g, spec, feat, labels = t_train._sampled_dataset("cora", 1.0, None, 0)
    cfg = GNNConfig(arch="gcn", in_dim=feat.shape[1], hidden_dim=32,
                    num_classes=spec.num_classes, num_layers=2,
                    backend="torch", device="cpu")
    lc = LoaderConfig(fanouts=(5, 3), batch_nodes=128, seed=0)
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0))
    step = ShardedSampledTrainStep(cfg, AdamWConfig(lr=1e-2), 2, graph=g,
                                   feat=feat, labels=labels, loader=lc)
    try:
        grads, loss, _ = step.value_and_grad(params, 3)
        assert [rep["step"] for rep in step.last] == [6, 7]
    finally:
        step.close()
    loader = SampledLoader(g, feat, labels, cfg, lc, start_thread=False)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    num = den = 0.0
    for b in (loader(6), loader(7)):
        lg = gnn_block_logits(cfg, leaves, b.feat,
                              [e.executor for e in b.entries])
        per = -torch.log_softmax(lg, -1).gather(1, b.labels[:, None])[:, 0]
        num = num + (per * b.mask).sum()
        den = den + b.mask.sum()
    ref = num / den
    ref_grads = torch.autograd.grad(ref, list(leaves.values()))
    assert abs(float(loss) - float(ref.detach())) <= 1e-4
    for k, rg in zip(leaves, ref_grads):
        assert _nerr(grads[k], rg) <= 1e-4, k


def test_serve_shards_matches_single_device_run():
    """``serve_gnn --shards 2 --smoke --stream-deltas 2`` on the async
    tier: accounting exact, every delta re-shards and agrees with a fresh
    split (1e-5); each of this stream's deltas dirties both shards, so
    both sub-plans are sent again (a delta that leaves a shard clean is
    `test_sharded_serve_update_sends_only_changed_subplans`); the last
    chunk's answers equal the single-device engine's on the mutated
    graph (1e-5)."""
    flags = ["--policy", "deadline", "--tenants", "3", "--stream-deltas",
             "2", "--smoke", "--device", "cpu", "--backend", "torch"]
    single = serve_gnn.run(flags)
    sharded = serve_gnn.run(flags + ["--shards", "2"])
    assert sharded["ok"] and single["ok"]
    acc = sharded["accounting"]
    assert acc["submitted"] == acc["completed"] + acc["rejected"] == 24
    assert sharded["updates"] == 2 and sharded["update_errors"] == 0
    assert len(sharded["delta_errs"]) == 2
    assert max(sharded["delta_errs"]) <= 1e-5
    assert sharded["sharded_fn"].resent == [[0, 1], [0, 1]]
    assert sharded["sharded_fn"].plan.epoch == 2
    assert set(sharded["summary"]) == {"t0", "t1", "t2"}
    eng = single["engine"]
    done = [r for r in sharded["requests"] if r.status == "done"]
    assert done
    for r in done:
        assert _nerr(r.result, eng.serve_batch([r.seed])[0]) <= 1e-5
    spans = {r["span"] for r in sharded["doc"]["spans"]}
    assert "serve_sharded" in spans
