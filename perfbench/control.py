"""Readings that set a cell's limits: the port on many seeds, and the
control and the planted faults on a few, at the cell's own size, in one
process (the plan is built once).  Not run by the benchmark's runs.

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3

Per seed it prints one JSON line: ``program`` (the timed path's first
steps or a request against the reference) and, on a control seed,
``control`` (the reference in TF32 in the program's place: float32 with
the operands of every product rounded to TF32's mantissa, the step below
the configuration's float32 with TF32 off) and ``faults``, planted in the
float32 reference in the program's place; every reading is against the
float64 reference, as a run's are:
  train: ``half_batch`` (half of the masked nodes left out of the loss,
         the mean taken over the rest); ``update_doubled`` (each AdamW
         step moves the parameters twice as far, its moments right);
         a state left unchanged reads 1 on ``grad_gap`` and
         ``move_gap`` by their measure (its first moment and its change
         are zero) and needs no run;
  infer: ``answer_altered`` (one node's two best logits swapped, so it
         answers its second class), ``half_nodes`` (half of the nodes'
         logits left at zero).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from perfbench import check, harness  # noqa: E402
from perfbench.inputs import make_inputs  # noqa: E402
from perfbench.reference import gnn as ref  # noqa: E402
from perfbench.system import build_system  # noqa: E402


def context(workload: str, **kw):
    """The cell's context as a run builds it (``kw`` as for
    `harness.cell_context`: device, backend, num_nodes, cache_dir)."""
    return harness.cell_context(harness.load_benchmark(), workload, seed=0,
                                seconds=0.0, trace=False,
                                t0=time.perf_counter(), **kw)


def _half(mask: torch.Tensor, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=mask.device).manual_seed(seed)
    keep = torch.rand(mask.shape, generator=gen, device=mask.device) < 0.5
    return mask * keep


def _infer_faults(base: torch.Tensor, seed: int) -> dict:
    altered = base.clone()
    v = int(torch.randint(base.shape[0], (1,),
                          generator=torch.Generator().manual_seed(seed)))
    top = altered[v].topk(2).indices
    altered[v, top] = altered[v, top.flip(0)]
    halved = base * _half(torch.ones(base.shape[0], device=base.device),
                          seed)[:, None]
    return {name: check.infer_numbers([lg], [lg.argmax(-1).cpu()], base)
            for name, lg in (("answer_altered", altered),
                             ("half_nodes", halved))}


def readings(ctx, seeds, control_seeds, emit=print):
    """One JSON-able dict per seed (see the module docstring)."""
    drv = harness.driver_of(ctx)
    f32 = torch.float32
    train = ctx.mix["kind"] == "train"
    sysm = build_system(ctx, with_backward=train)
    step_fn = drv.make_step(ctx, sysm) if train else None
    g = ctx.graph
    out = []
    for seed in seeds:
        inp = make_inputs(ctx.arch, ctx.config, seed, g.num_nodes,
                          g.num_edges / g.num_nodes, ctx.device)
        row = {"seed": seed}
        if train:
            _, _, prog, p0 = drv.first_steps(ctx, sysm, step_fn, inp)
            adj = drv.adjacency(ctx)
            base = drv.reference_readings(ctx, inp, p0, adj)
            row["program"] = check.train_numbers(*prog, *base)
            if seed in control_seeds:
                row["control"] = check.train_numbers(*drv.reference_readings(
                    ctx, inp, p0, adj, matmul=ref.tf32_matmul, dtype=f32),
                    *base)
                opt = dict(ctx.mix["optimizer"])
                opt["lr"] *= 2.0
                row["faults"] = {
                    "half_batch": check.train_numbers(*drv.reference_readings(
                        ctx, inp, p0, adj, mask=_half(inp["mask"], seed),
                        dtype=f32), *base),
                    "update_doubled": check.train_numbers(
                        *drv.reference_readings(ctx, inp, p0, adj, dtype=f32,
                                                opt=opt), *base)}
            del adj
        else:
            feat = sysm.to_plan(inp["feat"])
            lg, cls = drv.request(sysm.model, inp["params"], feat)
            lg, cls = sysm.from_plan(lg), sysm.from_plan(cls)
            del feat
            base = drv.reference_logits(ctx, inp)
            row["program"] = check.infer_numbers([lg], [cls], base)
            if seed in control_seeds:
                tf = drv.reference_logits(ctx, inp, ref.tf32_matmul, f32)
                row["control"] = check.infer_numbers(
                    [tf], [tf.argmax(-1).cpu()], base)
                row["faults"] = _infer_faults(base, seed)
            del lg, cls, base
        del inp
        emit(json.dumps(row))
        out.append(row)
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    cs = {int(s) for s in args.control_seeds.split(",") if s}
    t = time.perf_counter()
    readings(context(args.workload), seeds, cs,
             emit=lambda s: print(s, flush=True))
    print(f"# {time.perf_counter() - t:.1f} s, "
          f"{torch.cuda.get_device_name()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
