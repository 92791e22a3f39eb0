"""The dry-run tier (`repro_torch.launch.cost`, `dryrun_lib`, `dryrun`)
against the JAX package's (`repro.launch.dryrun_lib`, `hlo_analysis`,
`hlo_cost`), on the CPU.

Exact: parameter counts and model FLOPs of every arch at full config for
every runnable shape, the roofline terms, the matmul FLOPs of a known
program, the fake trace's memory peak and costs against the same step run
for real, and the traced collective bytes against the counter read on
real gloo ranks.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, ShapeDef, arch_names, get_arch
from repro_torch.configs import cell_is_runnable as t_runnable
from repro_torch.hw import H100_SXM
from repro_torch.kernels import selective_scan as t_scan
from repro_torch.launch import cost, dryrun, dryrun_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]

CELLS = [(a, s) for a in arch_names() for s in SHAPES
         if t_runnable(get_arch(a), s)[0]]


@functools.lru_cache(maxsize=None)
def _ref_full(arch: str):
    from repro.configs import get_arch as j_get_arch
    from repro.launch.dryrun_lib import abstract_params_and_specs
    cfg = j_get_arch(arch).full()
    return cfg, abstract_params_and_specs(cfg)[0]


@functools.lru_cache(maxsize=None)
def _port_full(arch: str):
    cfg = get_arch(arch).full()
    return cfg, dryrun_lib.abstract_params_and_specs(cfg)[0]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_params_and_model_flops_match_reference(arch, shape):
    from repro.launch import dryrun_lib as j_dryrun
    jcfg, jparams = _ref_full(arch)
    cfg, params = _port_full(arch)
    assert dryrun_lib.active_param_fraction(cfg, params) == \
        j_dryrun.active_param_fraction(jcfg, jparams)
    assert dryrun_lib.model_flops(cfg, params, shape) == \
        j_dryrun.model_flops(jcfg, jparams, shape)


def test_every_arch_has_a_runnable_cell_and_long_skips_match():
    from repro.configs import get_arch as j_get_arch
    from repro.configs.base import cell_is_runnable as j_runnable
    skipped = [a for a in arch_names()
               if not t_runnable(get_arch(a), "long_500k")[0]]
    assert len(skipped) == 5
    for a in arch_names():
        assert t_runnable(get_arch(a), "long_500k") == \
            j_runnable(j_get_arch(a), "long_500k")
    assert len(CELLS) == 4 * len(arch_names()) - 5


# ---------------------------------------------------------------------------
# the cost counter on known programs


@pytest.mark.parametrize("fake", [False, True])
def test_matmul_loop_counts_trip_times_dot_flops(fake):
    """As `tests/test_transformer.py` holds `module_cost`: ``trips``
    products of (n, d) @ (d, d) count 2 n d^2 trips FLOPs, exactly."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n, d, trips = 64, 128, 10
    mode = FakeTensorMode() if fake else None
    if mode is not None:
        mode.__enter__()
    try:
        x, w = torch.ones(n, d), torch.ones(d, d)
        with cost.CostCounter() as c:
            for _ in range(trips):
                x = x @ w
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)
    assert c.product_flops == c.flops == 2 * n * d * d * trips
    assert c.ops["mm"].calls == trips
    assert c.ops["mm"].bytes == trips * 4 * (n * d + d * d + n * d)


def test_elementwise_reduction_and_view_rules():
    a, b = torch.ones(1000), torch.ones(1000)
    m = torch.ones(20, 50)
    with cost.CostCounter() as c:
        s = a + b                              # 1000 FLOP, 3 x 4000 B
    assert (c.flops, c.bytes_accessed) == (1000, 12_000)
    with cost.CostCounter() as c:
        v = m.view(50, 20).t()[3:]             # views: nothing
        v2 = m.reshape(1000)
    assert (c.flops, c.bytes_accessed, c.ops) == (0, 0, {})
    assert (v.shape, v2.shape) == ((17, 50), (1000,))
    with cost.CostCounter() as c:
        r = m.sum(dim=1)                       # 1 FLOP an input element
        h = m.to(torch.bfloat16)               # a conversion: 1 an output
    assert c.ops["sum"].flops == 1000 and c.ops["sum"].bytes == 4000 + 80
    assert c.ops["_to_copy"].flops == 1000
    assert c.ops["_to_copy"].bytes == 4000 + 2000
    with cost.CostCounter() as c:
        s.copy_(a)                             # the destination is not read
    assert (c.flops, c.bytes_accessed) == (1000, 8000)
    assert r.shape == (20,) and h.dtype == torch.bfloat16


def test_live_storage_peak():
    with cost.CostCounter() as c:
        a = torch.ones(1000)                   # 4000 -> 4096 (512 rounding)
        b = torch.ones(100)                    # 400 -> 512
        del a
        d = torch.ones(10)                     # 40 -> 512
    assert c.peak_bytes == 4096 + 512
    assert c.live_bytes == 512 + 512
    assert b.numel() + d.numel() == 110


def test_scan_fake_path_builds_and_launches_nothing(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    def load(name):
        raise AssertionError(f"the fake path built {name}")

    monkeypatch.setattr(t_scan.build, "load", load)
    B, S, di, N = 2, 48, 64, 16
    t_scan.reset_launches()
    seen = []
    with FakeTensorMode():
        args = [torch.empty(B, S, di), torch.empty(B, S, di),
                torch.empty(B, S, N), torch.empty(B, S, N),
                torch.empty(di, N), torch.empty(di), torch.empty(di)]
        t_scan.cost_sinks.append(lambda *a: seen.append(a))
        try:
            with torch.no_grad():
                y = t_scan.selective_scan(*args)
        finally:
            t_scan.cost_sinks.pop()
    assert is_fake(y) and y.shape == (B, S, di) and y.dtype == torch.float32
    assert t_scan.launches == {t_scan.KERNEL: 0, t_scan.PLAIN: 0}
    assert seen == [(t_scan.KERNEL,) + t_scan.kernel_cost(B, S, di, N)]
    flops, nbytes = t_scan.kernel_cost(B, S, di, N)
    assert flops == 7 * B * S * di * N
    assert nbytes == 4 * (3 * B * S * di + 2 * B * S * N + di * N + 2 * di)


# ---------------------------------------------------------------------------
# the roofline terms against the reference's


@pytest.mark.parametrize("flops,nbytes,coll,chips,bf16", [
    (3.2e15, 1.1e12, 4.0e10, 1, True), (1e12, 5e12, 0.0, 1, True),
    (1e9, 1e6, 9e12, 4, False), (7.7e14, 2.3e11, 1.9e11, 256, True)])
def test_roofline_terms_match_reference(flops, nbytes, coll, chips, bf16):
    from repro.hw import TPUSpec
    from repro.launch.hlo_analysis import roofline_terms as j_roofline
    h = H100_SXM
    spec = TPUSpec(name="h100", peak_flops_bf16=h.peak_flops_bf16,
                   peak_flops_f32=h.peak_flops_f32, hbm_bw=h.hbm_bw,
                   hbm_bytes=h.hbm_bytes, vmem_bytes=h.smem_per_sm,
                   smem_bytes=h.smem_per_block, ici_link_bw=h.link_bw_intra,
                   ici_links=18, grid_step_overhead_s=0.0)
    kw = dict(flops=flops, bytes_accessed=nbytes,
              collective_total_bytes=coll, num_chips=chips, bf16=bf16)
    assert cost.roofline_terms(**kw) == j_roofline(hw=spec, **kw)


def test_link_figures_and_node_crossing():
    assert (H100_SXM.link_bw_intra, H100_SXM.link_bw_inter,
            H100_SXM.node_cards) == (450e9, 50e9, 8)
    grid = dryrun_lib._Grid((16, 16), ("data", "model"))
    assert dryrun_lib._node_crossing(grid, 0, ("model",), 8)
    assert dryrun_lib._node_crossing(grid, 0, ("data",), 8)
    small = dryrun_lib._Grid((2, 4), ("data", "model"))
    assert not dryrun_lib._node_crossing(small, 0, ("model",), 8)
    assert not dryrun_lib._node_crossing(small, 5, ("data", "model"), 8)


# ---------------------------------------------------------------------------
# the fake trace against the same step run for real


SMALL = {"train": ShapeDef("train_4k", "train", 32, 4),
         "prefill": ShapeDef("prefill_32k", "prefill", 32, 2),
         "decode": ShapeDef("decode_32k", "decode", 32, 2)}


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen3-moe-235b-a22b",
                                  "jamba-v0.1-52b"])
def test_fake_trace_equals_real_cpu_step(arch):
    """A reduced train step on a (1, 1) mesh: the fake trace's memory
    peak, arguments, FLOPs and bytes equal the live-storage tracker's on
    the same step run for real on the CPU."""
    kw = dict(use_reduced=True, shape_override=SMALL["train"], n_micro=2,
              verbose=False)
    fake = dryrun_lib.run_cell(arch, "train_4k", (1, 1), "one", **kw)
    real = dryrun_lib.run_cell(arch, "train_4k", (1, 1), "one", real="cpu",
                               **kw)
    assert fake["memory"] == real["memory"]
    assert fake["memory"]["peak_bytes"] > 0
    assert fake["cost"] == real["cost"]
    assert fake["collectives"]["total_bytes"] == 0


def _ref_report_keys() -> set:
    src = (ROOT / "src" / "repro" / "launch" / "dryrun_lib.py").read_text()
    body = src[src.index("def run_cell("):]
    keys = set(re.findall(r'report\["(\w+)"\]', body))
    head = body[body.index("report = {"):body.index("}", body.index(
        "report = {"))]
    keys |= set(re.findall(r'"(\w+)":', head))
    return keys


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_gives_the_reference_keys(kind, tmp_path):
    """The reference's report keys, with ``trace_s`` for ``lower_s`` /
    ``compile_s``, no ``hlo_bytes`` (no HLO text) and no
    ``cost_builtin`` (XLA's own count, which visits a loop body once);
    the collectives' three keys, the roofline's five."""
    shape = SMALL[kind]
    rep = dryrun_lib.run_cell("jamba-v0.1-52b", shape.name, (2, 2), "t",
                              use_reduced=True, shape_override=shape,
                              out_dir=str(tmp_path), save_ops=True,
                              verbose=False)
    want = _ref_report_keys() - {"lower_s", "compile_s", "hlo_bytes",
                                 "cost_builtin", "skipped"} | {"trace_s"}
    assert "params" in want and "useful_flops_ratio" in want
    assert want <= set(rep)
    assert {"flops", "bytes_accessed"} <= set(rep["cost"])
    assert {"by_kind", "counts", "total_bytes"} <= set(rep["collectives"])
    assert set(rep["roofline"]) == {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "dominant", "bound_s"}
    m = rep["memory"]
    assert m["total_bytes"] == m["argument_bytes"] + m["peak_bytes"]
    assert m["fits"] is True and m["peak_bytes"] > 0
    assert rep["useful_flops_ratio"] > 0 and rep["cost"]["flops"] > 0
    assert rep["collectives"]["total_bytes"] > 0
    assert rep["node_crossing_axes"] == []
    saved = json.loads((tmp_path / dryrun_lib.cell_filename(
        "jamba-v0.1-52b", shape.name, "t")).read_text())
    assert saved["memory"] == m
    ops = json.loads((tmp_path / dryrun_lib.cell_filename(
        "jamba-v0.1-52b", shape.name, "t").replace(".json", ".ops.json"))
        .read_text())
    assert sum(r["flops"] for r in ops) == rep["cost"]["flops"]
    if kind == "prefill":                    # the scan's own figure
        assert any(r["op"] == t_scan.KERNEL for r in ops)


@pytest.mark.parametrize("arch", [a for a in arch_names()
                                  if not t_runnable(get_arch(a),
                                                    "long_500k")[0]])
def test_long_500k_skipped_with_the_reference_reason(arch):
    from repro.configs import get_arch as j_get_arch
    from repro.configs.base import cell_is_runnable as j_runnable
    rep = dryrun_lib.run_cell(arch, "long_500k", (16, 16), "pod16x16",
                              verbose=False)
    assert rep["skipped"] == j_runnable(j_get_arch(arch), "long_500k")[1]
    assert rep["num_chips"] == 256 and "memory" not in rep


def test_refuses_an_existing_process_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun_lib.run_cell("h2o-danube-1.8b", "decode_32k", (1, 2), "t",
                                use_reduced=True,
                                shape_override=SMALL["decode"], verbose=False)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# traced collective bytes against the counter on real gloo ranks


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.as_tensor(tok[:, :-1]),
            "labels": torch.as_tensor(tok[:, 1:]),
            "pos": torch.arange(S, dtype=torch.int32).expand(B, S)
            .contiguous()}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_traced_collectives_equal_the_ranks_counter(kind, mesh_shape):
    _check_traced_collectives(kind, mesh_shape)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_traced_collectives_equal_the_ranks_counter_with_replicated_heads(
        kind):
    """3 query heads and 1 kv head on a model axis of 4: attention runs
    replicated over ``model`` (no ``wo`` all-reduce), in the trace as on
    the ranks."""
    _check_traced_collectives(kind, (1, 4), n_heads=3, n_kv=1)


def _check_traced_collectives(kind, mesh_shape, **heads):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import (LMModel, make_prefill_step,
                                       make_train_step)
    from repro_torch.nn.transformer import lm_param_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    arch = "h2o-danube-1.8b" if kind == "train" else "jamba-v0.1-52b"
    shape = SMALL[kind]
    overrides = dict(heads, dtype=torch.float32)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    want = dryrun_lib.run_cell(
        arch, shape.name, mesh_shape, "t", use_reduced=True,
        shape_override=shape, n_micro=2 if kind == "train" else 1,
        config_overrides=overrides, verbose=False)
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    params = LMModel.create(cfg, seed=0, device="cpu").params
    batch = _batch(cfg, shape.global_batch, shape.seq_len, seed=1)
    kw = dict(mesh=mesh, param_specs=lm_param_specs(cfg), params_shape=params)
    if kind == "train":
        step = make_train_step(cfg, AdamWConfig(), n_micro=2, donate=False,
                               **kw).step
        mesh.group.collectives(reset=True)
        step(params, adamw_init(params), batch)
    else:
        step, _ = make_prefill_step(cfg, backend="torch", **kw)
        mesh.group.collectives(reset=True)
        step(params, batch["tokens"], batch["pos"])
    got = mesh.group.collectives(reset=True)[want["rank"]]
    assert got["by_kind"] == want["collectives"]["by_kind"]
    assert got["counts"] == want["collectives"]["counts"]
    assert got["total_bytes"] == want["collectives"]["total_bytes"] > 0


# ---------------------------------------------------------------------------
# the CLI


def test_cli_list_and_exit_codes(capsys, monkeypatch, tmp_path):
    assert dryrun.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == arch_names()
    calls = []

    def stub(arch, shape, mesh_shape, mesh_name, **kw):
        calls.append((arch, shape, tuple(mesh_shape), mesh_name,
                      kw["out_dir"], kw["n_micro"], kw["save_ops"]))
        if arch == "gemma2-2b":
            raise RuntimeError("no trace")
        return {"memory": {"fits": arch != "gemma2-9b"}}

    monkeypatch.setattr(dryrun_lib, "run_cell", stub)
    out = str(tmp_path)
    # a cell that does not fit is reported, not failed
    assert dryrun.main(["--arch", "gemma2-9b", "--shape", "train_4k",
                        "--out", out, "--n-micro", "2", "--save-ops"]) == 0
    assert calls == [("gemma2-9b", "train_4k", (16, 16), "pod16x16", out, 2,
                      True)]
    calls.clear()
    assert dryrun.main(["--arch", "gemma2-2b", "--arch", "h2o-danube-1.8b",
                        "--shape", "decode_32k", "--mesh", "both",
                        "--out", out]) == 1
    assert [c[:4] for c in calls] == [
        ("gemma2-2b", "decode_32k", (16, 16), "pod16x16"),
        ("h2o-danube-1.8b", "decode_32k", (16, 16), "pod16x16"),
        ("gemma2-2b", "decode_32k", (2, 16, 16), "pod2x16x16"),
        ("h2o-danube-1.8b", "decode_32k", (2, 16, 16), "pod2x16x16")]
    assert "2 cell(s) failed" in capsys.readouterr().err


def test_cli_runs_a_full_config_cell(tmp_path):
    """One production cell end to end: h2o-danube-1.8b at full config,
    decode_32k on the (16, 16) mesh."""
    out = tmp_path / "reports"
    assert dryrun.main(["--arch", "h2o-danube-1.8b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    rep = json.loads((out / "h2o-danube-1.8b__decode_32k__pod16x16.json")
                     .read_text())
    assert rep["num_chips"] == 256 and rep["memory"]["fits"]
    from repro_torch.distributed.sharding import tree_leaves
    assert rep["params"]["total"] == sum(
        t.numel() for t in tree_leaves(_port_full("h2o-danube-1.8b")[1]))
    assert set(rep["node_crossing_axes"]) == {"data", "model"}
    assert rep["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-vl-2b"])
def test_cli_runs_a_replicated_attention_cell(arch, tmp_path):
    """A production cell whose heads the model axis (16) does not divide
    (gemma2-2b 8 / 4, qwen2-vl-2b 12 / 2) traces at full config, its
    attention replicated over ``model``: decode issues no ``wo``
    all-reduce, so a layer's all-reduces are the sequence-split cache's
    two and the FFN's (plus one for a vocab-parallel embedding)."""
    out = tmp_path / "reports"
    assert dryrun.main(["--arch", arch, "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    rep = json.loads((out / f"{arch}__decode_32k__pod16x16.json")
                     .read_text())
    cfg = _port_full(arch)[0]
    assert cfg.n_heads % 16 and cfg.n_kv % 16
    assert rep["num_chips"] == 256 and rep["memory"]["fits"]
    assert rep["collectives"]["counts"]["all-reduce"] == (
        3 * cfg.n_layers + (cfg.frontend == "tokens"))
    assert all(x > 0 for x in (rep["cost"]["flops"],
                               rep["collectives"]["total_bytes"]))


def test_mesh_prefill_holds_only_the_ranks_kv_slots():
    """A cache split over the sequence on ``model``: each further layer
    adds at most its rank's slots of k and v to the prefill's peak, not
    the layer's whole k and v (a view of the whole would keep it)."""
    B, S = 4, 256
    cfg = get_arch("h2o-danube-1.8b").reduced()
    peaks = [dryrun_lib.run_cell(
        "h2o-danube-1.8b", "prefill_32k", (1, 4), "t", use_reduced=True,
        shape_override=ShapeDef("p", "prefill", S, B), verbose=False,
        config_overrides={"n_layers": n, "dtype": torch.float32})[
            "memory"]["peak_bytes"] for n in (2, 4, 6)]
    kv_whole = 2 * B * S * cfg.n_kv * cfg.head_dim * 4     # k and v, f32
    assert cfg.n_kv % 4 != 0
    assert peaks[2] - peaks[1] == peaks[1] - peaks[0]
    assert 0 < (peaks[1] - peaks[0]) / 2 <= kv_whole / 4


def test_in_place_updates_of_arguments_allocate_nothing():
    """An argument's storage, first seen as an input, is not counted when
    an in-place op or a copy returns it (the optimizer's updates)."""
    p, g = torch.ones(1000), torch.ones(1000)
    with cost.CostCounter() as c:
        p.mul_(0.5).add_(g)
        p.copy_(g)
        q = p * 2                              # a new storage: counted
    assert c.peak_bytes == c.live_bytes == 4096
    assert q.shape == (1000,)


def test_gloo_transport_adds_the_reduce_scatter_staging():
    """On gloo a reduce-scatter holds a copy of its operand on top of what
    is live at it; NCCL's peak is the trace's own."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.ranks import reduce_scatter_rows
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with FakeTensorMode():
            x = torch.empty(1024)
            with cost.CostCounter() as c:
                y = x * 2                      # 4096 B live
                out = reduce_scatter_rows(y)   # + 2048 B; stages 4096 B
                del y
    finally:
        dist.destroy_process_group()
    assert out.shape == (512,)
    assert (c.peak_bytes, c.gloo_peak_bytes) == (6144, 6144 + 4096)
    assert c.collectives["by_kind"]["reduce-scatter"] == 4096

    kw = dict(use_reduced=True, shape_override=SMALL["train"], n_micro=2,
              verbose=False)
    nccl = dryrun_lib.run_cell("h2o-danube-1.8b", "train_4k", (2, 2), "t",
                               **kw)
    gloo = dryrun_lib.run_cell("h2o-danube-1.8b", "train_4k", (2, 2), "t",
                               transport="gloo", **kw)
    assert (nccl["memory"]["transport"], gloo["memory"]["transport"]) == (
        "nccl", "gloo")
    assert gloo["memory"]["peak_bytes"] >= nccl["memory"]["peak_bytes"]
    assert gloo["memory"]["argument_bytes"] == \
        nccl["memory"]["argument_bytes"]
    assert gloo["collectives"] == nccl["collectives"]
    with pytest.raises(ValueError, match="transport"):
        dryrun_lib.run_cell("h2o-danube-1.8b", "train_4k", (2, 2), "t",
                            transport="mpi", **kw)
