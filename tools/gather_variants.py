#!/usr/bin/env python3
"""Compare compile-time variants of the gather aggregation kernel
(`src/repro_torch/kernels/csrc/group_aggregate_gather.cu`, the ``direct``
variant) on the card: a development probe beside `chip_smoke.py`, which
checks the kernel as shipped.

    python3 tools/gather_variants.py                 # from the repo root
    python3 tools/gather_variants.py --variants base,ahead4 --reddit
    python3 tools/gather_variants.py --timeline

A variant is the kernel source with textual replacements (its compile-time
constants) and patched module constants of the wrapper
(`repro_torch.kernels.group_aggregate`); ``schedule-order`` is the shipped
kernel launching the runs in schedule order instead of longest first.  Every variant is compiled at once
with the repository's nvcc flags into ``build/repro_torch/variants/``,
checked against the plain version on each case (chip_smoke's
`KernelCase.holds`), then timed (device time, `chip_smoke.time_ms` with
``device_only``): the GIN serving shape (the largest schedule of
chip_smoke's ``gin-f32`` serving run, D 500, float32), the pubmed
replica's direct schedule at D 500 float32 and, with ``--reddit``, the
full reddit replica's direct schedule at D 16 and 64 float32.  Prints one
JSON line per variant.

``--timeline`` instead builds the first variant with per-block clock
stamps (`TIMELINE`) and prints where one launch at the GIN serving shape
spends its time: the span, blocks resident per SM, each block's duration by
its run's live slots, and the median share of a block's cycles in setup
(run bounds, the first metadata loads, zeroing the partials), the walk
over the run's slots (metadata, lists and the flushes on the way), the last
list flush and the final sum.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
SOURCE = "group_aggregate_gather"


def _const(name: str, value: int) -> tuple:
    """The replacement of one `constexpr int` of the kernel source."""
    import re
    path = os.path.join(ROOT, "src/repro_torch/kernels/csrc", SOURCE + ".cu")
    with open(path) as f:
        m = re.search(rf"constexpr int {name} = \d+;", f.read())
    if m is None:
        raise SystemExit(f"constant {name} not in the kernel source")
    return (m.group(0), f"constexpr int {name} = {value};")


# name -> (source constants {name: value}, wrapper constants {name: value})
VARIANTS = {
    "base": ({}, {}),
    "unroll2": ({"kUnroll": 2}, {}),
    "unroll8": ({"kUnroll": 8}, {}),
    "ahead4": ({"kAhead": 4}, {}),
    "warps4": ({"kWarps": 4, "kMinBlocks": 8}, {"_GATHER_WARPS": 4}),
    "list64-min5": ({"kListCap": 64, "kMinBlocks": 5}, {"_GATHER_LIST": 64}),
    "schedule-order": ({}, {}),
}
# variants that launch the runs in schedule order, not in
# `DeviceSchedule.run_order` (longest first)
SCHEDULE_ORDER = {"schedule-order"}

# per-block stamps: (anchor in the source, text put after it)
TIMELINE = [
    ('#include "common.cuh"\n',
     "__device__ unsigned long long g_tl[12 * 65536];\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  const unsigned long long tg0 = gtimer();\n"
     "  const long long tc0 = clock64();\n"),
    ("    reinterpret_cast<float4*>(parts)[i] = make_float4(0.f, 0.f, 0.f, 0.f);\n"
     "  __syncthreads();\n",
     "  const long long tc1 = clock64();\n"),
]
TIMELINE_WRAP = [
    ("  flush(cnt);\n  __syncthreads();\n",
     "  const long long tc2 = clock64(); flush(cnt);\n"
     "  const long long tc3 = clock64();\n  __syncthreads();\n"
     "  const long long tc4 = clock64();\n"),
    ("    *reinterpret_cast<float4*>(out + (row0 + r) * d_pad + col0 + c4) = s;\n"
     "  }\n}\n",
     "    *reinterpret_cast<float4*>(out + (row0 + r) * d_pad + col0 + c4) = s;\n"
     "  }\n"
     "  const unsigned blk = blockIdx.x;\n"
     "  if (lane == 0 && blk < 65536) {\n"
     "    unsigned long long* g = g_tl + 12 * blk;\n"
     "    atomicMax(g + 6, (unsigned long long)(tc2 - tc1));\n"
     "    atomicMax(g + 7, (unsigned long long)(tc3 - tc2));\n"
     "    atomicAdd(g + 8, (unsigned long long)cnt_total);\n"
     "    if (warp == 0) {\n"
     "      unsigned sm; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "      g[0] = tg0; g[1] = tc1 - tc0; g[2] = tc4 - tc0;\n"
     "      g[3] = clock64() - tc0; g[4] = sm; g[5] = t1 - t0;\n"
     "      g[10] = gtimer();\n    }\n  }\n}\n"
     'extern "C" int repro_timeline(void* host, int blocks, int clear) {\n'
     "  void* dev = nullptr;\n"
     "  cudaError_t e = cudaGetSymbolAddress(&dev, g_tl);\n"
     "  if (e != cudaSuccess) return (int)e;\n"
     "  if (clear) return (int)cudaMemset(dev, 0, sizeof(g_tl));\n"
     "  return (int)cudaMemcpy(host, dev, 96ull * blocks,\n"
     "                         cudaMemcpyDeviceToHost);\n}\n"),
    ("  int cnt = 0;  // entries in the list (warp-uniform)\n",
     "  int cnt = 0;  // entries in the list (warp-uniform)\n"
     "  int cnt_total = 0;\n"),
    ("      cnt += __popc(m);\n",
     "      cnt += __popc(m);\n      cnt_total += __popc(m);\n"),
]


def _apply(text: str, edits, after: bool) -> str:
    for anchor, new in edits:
        if anchor not in text:
            raise SystemExit(f"anchor {anchor!r} not in the kernel source")
        text = text.replace(anchor, anchor + new if after else new, 1)
    return text


def build_variants(names, timeline=False):
    from repro_torch.kernels import build
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    if timeline:
        src = _apply(_apply(src, TIMELINE, True), TIMELINE_WRAP, False)
    procs = {}
    for name in names:
        text = src
        for const, value in VARIANTS[name][0].items():
            old, new = _const(const, value)
            text = text.replace(old, new)
        d = os.path.join(build.BUILD_DIR, "variants",
                         name + ("-timeline" if timeline else ""))
        os.makedirs(d, exist_ok=True)
        shutil.copy(build.CSRC / "common.cuh", d)
        cu = os.path.join(d, f"{SOURCE}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{out}")
        ptxas = sorted({l.split("info    :")[-1].strip()
                        for l in out.splitlines()
                        if "Used" in l or "spill" in l})
        libs[name] = (ctypes.CDLL(lib), ptxas)
    return libs


def gin_case():
    """The GIN serving shape: the largest schedule chip_smoke's gin-f32
    serving run builds, at D 500 float32."""
    import chip_smoke as cs
    from repro_torch.launch import serve_gnn
    name, variant, width, flags = next(p for p in cs.SERVE_PHASES
                                       if p[0] == "gin-f32")
    res = serve_gnn.run(cs.SERVE_COMMON + flags + ["--variant", variant])
    eng = res["engine"]
    ent = max(eng.cache._plans.values(),
              key=lambda e: e.plan.partition.num_tiles)
    return cs.KernelCase(ent.executor.sched, ent.plan.graph,
                         ent.plan.partition.edge_values_csr(), width,
                         eng.cfg.compute_dtype, variant, ent.plan.config.dt,
                         seed=7)


def cases(reddit: bool) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.core.advisor import plan_for
    from repro_torch.graphs.csr import random_power_law
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels.ops import DeviceSchedule
    from repro_torch.models.gnn import gcn_edge_values
    out = {"gin-d500": gin_case()}
    graphs = [("pubmed", random_power_law(19717, 4.5, seed=0), 16, (500,))]
    if reddit:
        graphs.append(("reddit", make_dataset("reddit", max_dim=1)[0], 64,
                       (16, 64)))
    for gname, graph, dim, widths in graphs:
        g, vals = gcn_edge_values(graph)
        plan = plan_for(g, arch="gcn", in_dim=dim, hidden_dim=dim,
                        edge_vals=vals, tune_iters=4, variant="direct")
        sched = DeviceSchedule(plan.partition, "cuda")
        for d in widths:
            out[f"{gname}-d{d}"] = cs.KernelCase(
                sched, g, vals, d, torch.float32, "direct", plan.config.dt,
                seed=d)
    return out


def _launch_order(name: str, cases) -> contextlib.ExitStack:
    """The run order variant ``name`` launches ``cases`` in."""
    import torch
    stack = contextlib.ExitStack()
    if name in SCHEDULE_ORDER:
        for case in cases:
            s = case.s
            stack.enter_context(mock.patch.object(
                s, "run_order", torch.arange(s.num_runs, dtype=torch.int32,
                                             device=s.device)))
    return stack


def timeline(name: str) -> dict:
    """One launch of variant ``name`` with stamps at the GIN serving shape
    (after 3 warm-up launches): where its blocks spend their time."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import group_aggregate as ga
    lib, ptxas = build_variants([name], timeline=True)[name]
    case = gin_case()
    geo = ga.launch_geometry("direct", gs=case.s.gs, gpt=case.s.gpt,
                             ont=case.s.ont, dt=case.dt)
    blocks = case.s.num_runs * -(-case.feat_p.shape[1] // geo.dc)
    with mock.patch.dict(build._libs, {SOURCE: lib}), \
            mock.patch.multiple(ga, **{"_GATHER_WARPS": ga._GATHER_WARPS,
                                       **VARIANTS[name][1]}), \
            _launch_order(name, [case]):
        for _ in range(3):
            case.kernel()
        torch.cuda.synchronize()
        lib.repro_timeline(None, 0, 1)
        case.kernel()
        torch.cuda.synchronize()
    raw = np.zeros(12 * blocks, dtype=np.uint64)
    code = lib.repro_timeline(ctypes.c_void_p(raw.ctypes.data), blocks, 0)
    if code:
        raise SystemExit(f"reading the timeline failed: CUDA error {code}")
    a = raw.reshape(blocks, 12).astype(np.int64)
    start = (a[:, 0] - a[:, 0].min()) / 1e3                 # us
    ns_per_cycle = float(np.median((a[:, 10] - a[:, 0]) / a[:, 3]))
    dur = a[:, 3] * ns_per_cycle / 1e3                     # us
    sm, tiles, live = a[:, 4], a[:, 5], a[:, 8]
    total = a[:, 3].astype(float)
    resident = []
    for s in np.unique(sm):
        st, en = start[sm == s], start[sm == s] + dur[sm == s]
        resident += [int(((st <= x) & (en > x)).sum()) for x in st]
    share = lambda x: round(float(np.median(x / total)), 3)
    longest = int(np.argmax(live))
    bins = ((0, 40), (40, 80), (80, 160), (160, 320), (320, 1 << 30))
    return {"variant": name, "ptxas": ptxas, "blocks": blocks,
            "runs": case.s.num_runs,
            "span_us": float((start + dur).max()),
            "last_block_start_us": float(start.max()),
            "block_us": {"median": float(np.median(dur)),
                         "p90": float(np.percentile(dur, 90)),
                         "max": float(dur.max())},
            "resident_blocks_per_sm": {"median": float(np.median(resident)),
                                       "max": int(max(resident))},
            "most_live_slots": {"live": int(live[longest]),
                                "tiles": int(tiles[longest]),
                                "start_us": float(start[longest]),
                                "us": float(dur[longest])},
            "block_us_median_by_live_slots": {
                f"{lo}-{hi}": float(np.median(dur[(live >= lo) & (live < hi)]))
                for lo, hi in bins if ((live >= lo) & (live < hi)).any()},
            "share": {"setup": share(a[:, 1]),
                      "walk": share(a[:, 6]),
                      "last_flush": share(a[:, 7]),
                      "final_sum": share(a[:, 3] - a[:, 2])}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reddit", action="store_true",
                    help="also the full reddit replica at D 16 and 64")
    ap.add_argument("--timeline", action="store_true",
                    help="where one launch's blocks spend their time (the "
                         "first of --variants)")
    args = ap.parse_args()
    names = args.variants.split(",")
    if args.timeline:
        print(json.dumps(timeline(names[0])), flush=True)
        return 0
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import group_aggregate as ga
    libs = build_variants(names)
    all_cases = cases(args.reddit)
    for name in names:
        lib, ptxas = libs[name]
        rec = {"variant": name, "ptxas": ptxas}
        with mock.patch.dict(build._libs, {SOURCE: lib}), \
                mock.patch.multiple(ga, **{"_GATHER_WARPS": ga._GATHER_WARPS,
                                           **VARIANTS[name][1]}), \
                _launch_order(name, all_cases.values()):
            for cname, case in all_cases.items():
                cs.KernelCase.holds(case.check(), f"{name} {cname}")
                rec[cname] = cs.time_ms(case.kernel, device_only=True)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
