"""The dry-run CLI: price every (architecture x input shape x production
mesh) cell for one rank, on any machine, without the cards.

Port of `src/repro/launch/dryrun.py`, with its flags.  The reference
compiles each cell for 512 placeholder TPU devices; the port traces each
cell's rank program on fake tensors in a fake process group of the
mesh's size (`repro_torch.launch.dryrun_lib.run_cell`), so it needs no
environment set before import and no card.  ``--save-hlo`` is
``--save-ops`` here: it writes the per-op table beside each report.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-moe-235b-a22b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The meshes are `launch/mesh.py:make_production_mesh`'s: ``pod16x16``,
(16, 16) over (data, model), and ``pod2x16x16``, (2, 16, 16) over (pod,
data, model).  Reports land in ``experiments/dryrun_torch/<arch>__
<shape>__<mesh>.json``.  Exit code 1 when a cell fails to trace; a cell
that does not fit its card is reported with ``fits: false`` and is not
a failure.
"""
from __future__ import annotations

import argparse
import sys
import traceback

MESHES = {"pod16x16": (16, 16), "pod2x16x16": (2, 16, 16)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", action="append", default=None,
                   help="architecture id (repeatable; default: all)")
    p.add_argument("--shape", action="append", default=None,
                   help="input shape name (repeatable; default: all)")
    p.add_argument("--mesh", choices=("single", "multi", "both"),
                   default="single")
    p.add_argument("--all", action="store_true",
                   help="run every (arch x shape) cell")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--n-micro", type=int, default=1)
    p.add_argument("--save-ops", action="store_true",
                   help="write each cell's per-op table beside its report")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)

    from repro_torch.configs import SHAPES, arch_names

    if args.list:
        for a in arch_names():
            print(a)
        return 0

    from repro_torch.launch.dryrun_lib import run_cell

    archs = args.arch or arch_names()
    shapes = args.shape or list(SHAPES)
    names = {"single": ["pod16x16"], "multi": ["pod2x16x16"],
             "both": ["pod16x16", "pod2x16x16"]}[args.mesh]

    failures = []
    for mesh_name in names:
        for arch in archs:
            for shape in shapes:
                try:
                    run_cell(arch, shape, MESHES[mesh_name], mesh_name,
                             n_micro=args.n_micro, out_dir=args.out,
                             save_ops=args.save_ops)
                except Exception:
                    failures.append((arch, shape, mesh_name))
                    print(f"[dryrun] FAILED {arch} x {shape} x {mesh_name}",
                          file=sys.stderr)
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} cell(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print("[dryrun] all requested cells traced")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
