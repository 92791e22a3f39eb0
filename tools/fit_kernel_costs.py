"""Fit the port's kernel-model costs to device times measured on the card.

`repro_torch.core.model.KERNEL_COSTS` holds, per raced gather kernel, the
costs `KernelModel` prices a call with; `CALL_S` is the host's share of
one executor call.  This tool refits ``device_s``, ``block_s``, ``slot_s``
and ``live_s`` of each kernel by least squares on log time, starting from
the shipped values (``chain_s`` is read off the longest-run probe and held),
and takes the host's share as the median of wall p50 - device p50.  It
prints the shipped and the refitted costs, each with its measured / model
ratios.  The shipped costs are the fit of `tools/kernel_cost_points.json`.

A point is ``{"what", "variant", "D", "config": [gs, gpt, dt, src_win,
ont], "feat_dtype", "tiles", "dev_s", "wall_s", "props": {"num_nodes",
"num_edges", "avg_degree", "max_degree"}}``.  An input file holds them
under ``points`` (as `tools/kernel_cost_points.json` does) or under
``profile.points`` (the detail file `chip_smoke.py` writes after its phase
8).  Needs scipy; no card:

    PYTHONPATH=src python tools/fit_kernel_costs.py tools/kernel_cost_points.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
from unittest import mock

from repro_torch.core import model
from repro_torch.core.extractor import GraphProps
from repro_torch.core.model import AggConfig, KernelModel

FITTED = ("device_s", "block_s", "slot_s", "live_s")
VARIANTS = ("folded", "direct")


def load_points(paths) -> list:
    pts = []
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        pts += doc["points"] if "points" in doc else doc["profile"]["points"]
    return pts


def _case(p: dict):
    pr = p["props"]
    props = GraphProps(
        num_nodes=pr["num_nodes"], num_edges=pr["num_edges"],
        avg_degree=pr["avg_degree"], max_degree=pr["max_degree"],
        degree_stddev=0.0, degree_cv=0.0, num_communities=1,
        community_size_mean=float(pr["num_nodes"]),
        community_size_stddev=0.0, numbering_spread=0.0)
    gs, gpt, dt, src_win, ont = p["config"]
    cfg = AggConfig(gs=gs, gpt=gpt, dt=dt, src_win=src_win, ont=ont,
                    variant=p["variant"], feat_dtype=p["feat_dtype"])
    return props, cfg


def ratios(points: list, costs: model.KernelCosts) -> list:
    """Measured / model device time of every point, priced with ``costs``
    in place of the shipped costs of the points' kernel."""
    out = []
    for p in points:
        props, cfg = _case(p)
        with mock.patch.dict(model.KERNEL_COSTS, {cfg.variant: costs}):
            t = KernelModel().terms(props, p["D"], cfg, tiles=p["tiles"])
        out.append(p["dev_s"] / t["t_device"])
    return out


def fit(points: list) -> dict:
    import numpy as np
    from scipy.optimize import least_squares

    out = {"call_s": statistics.median(p["wall_s"] - p["dev_s"]
                                       for p in points)}
    for v in VARIANTS:
        pts = [p for p in points if p["variant"] == v]
        base = model.KERNEL_COSTS[v]

        def costs(x):
            return dataclasses.replace(base, **dict(zip(FITTED, np.exp(x))))

        def residuals(x):
            return [math.log(r) for r in ratios(pts, costs(x))]

        x = least_squares(residuals, np.log([getattr(base, f)
                                             for f in FITTED])).x
        out[v] = {"points": len(pts), "shipped": base, "fitted": costs(x),
                  "ratios_shipped": ratios(pts, base),
                  "ratios_fitted": ratios(pts, costs(x))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+",
                    help="point files (points or profile.points)")
    args = ap.parse_args(argv)
    res = fit(load_points(args.files))
    print(f"host share of a call: {res['call_s'] * 1e6:.2f} us "
          f"(shipped CALL_S {model.CALL_S * 1e6:.2f} us)")
    for v in VARIANTS:
        r = res[v]
        for what in ("shipped", "fitted"):
            c, rs = r[what], r[f"ratios_{what}"]
            print(f"{v} {what} over {r['points']} points: "
                  + ", ".join(f"{f} {getattr(c, f):.4g}" for f in FITTED)
                  + f"; measured / model {min(rs):.2f}-{max(rs):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
