"""Rank-side functions of the sharded-execution tests.

A `RankGroup` pickles the function it runs by reference, so the rank
process imports this module: it imports only numpy, torch and
`repro_torch` (the test modules also import the JAX reference, which
the ranks never need)."""
import os
import time

import numpy as np
import torch


def psum_grads(rank: int, step: int, seed: int = 0) -> dict:
    """Rank ``rank``'s seeded gradient tree at error-feedback step
    ``step``: float32 leaves of mixed magnitudes."""
    rng = np.random.default_rng((seed, rank, step))
    return {"w": (rng.standard_normal((64, 32))
                  * rng.uniform(0.01, 10)).astype(np.float32),
            "b": (rng.standard_normal(32) * rng.uniform(0.01, 10)
                  ).astype(np.float32)}


def r_compressed_psum(r, steps: int, seed: int = 0) -> list:
    """``steps`` error-feedback `compressed_psum` calls on this rank's
    seeded gradients: [(totals, residuals)] as numpy trees."""
    from repro_torch.optim import compressed_psum
    ef, out = None, []
    for step in range(steps):
        g = {k: torch.from_numpy(v).to(r.device)
             for k, v in psum_grads(r.rank, step, seed).items()}
        tot, ef = compressed_psum(g, ef)
        out.append(({k: v.cpu().numpy() for k, v in tot.items()},
                    {k: v.cpu().numpy() for k, v in ef.items()}))
    return out


def r_fail_on(r, bad_rank: int, how: str):
    """Rank ``bad_rank`` raises (``how="raise"``) or sleeps past any
    test timeout (``"hang"``); the others wait in a collective."""
    from repro_torch.distributed.ranks import all_reduce_
    if r.rank == bad_rank:
        if how == "raise":
            raise ValueError(f"rank {r.rank} fails on purpose")
        time.sleep(3600)
    return float(all_reduce_(torch.ones(1))[0])


def r_pid(r) -> int:
    return os.getpid()


def r_echo(r, x):
    """``x`` back to the caller (the transport's round trip)."""
    return x


def r_saved_calls(r, key) -> int:
    """How many aggregation calls' saved tensors this rank holds for the
    executor ``key``."""
    return len(r.state[key].get("saved", {}))


def r_axis_collectives(r, mesh_key: str) -> dict:
    """This rank's coordinates on the mesh under ``mesh_key`` and, over
    each axis and over both, the all-reduced sum and the all-gather of
    its global rank."""
    mesh = r.state[mesh_key]
    me = torch.tensor([float(r.rank)])
    out = {"coords": dict(mesh.coords)}
    for axes in [("data",), ("model",), ("data", "model")]:
        out[axes] = (float(mesh.all_reduce(me.clone(), axes)[0]),
                     mesh.all_gather(me, axes).tolist(),
                     mesh.index(axes))
    out["max"] = float(mesh.all_reduce(me.clone(), ("model",), op="max")[0])
    return out
