"""A group of rank processes behind one caller: the port's device mesh.

Port-only module, the counterpart of the reference's
`src/repro/distributed/graph_shard.py:53` ``shard_mesh``.  The reference
runs one controller over a ``shard_map`` mesh: a single program sees
every device, and a collective is a named-axis operation inside it.
PyTorch has no such controller: `torch.distributed` is one process per
rank.  So the port keeps the reference's single-caller signatures
(``make_sharded_logits_fn(cfg, shards)(params, feat)`` and friends are
called from one process) and runs a group of ``P`` rank processes behind
them.  This module is that group:

  * the ranks start with the ``spawn`` start method (CUDA cannot be
    initialized again after a fork) and initialize `torch.distributed`
    through a ``file://`` rendezvous in a fresh temporary directory, so
    parallel test workers never race for a port;
  * the caller sends every rank a module-level function and its
    arguments (`RankGroup.run`); each rank runs it with its `Rank`
    context and sends the result back.  Large inputs (a sub-plan, a
    feature slice, a graph) are sent once and kept in the rank's
    ``state``; their arrays travel as files in the group's temporary
    directory, not through the pipe;
  * every init and every call has a timeout.  A rank that raises, dies
    or outlives the timeout makes the caller raise `RankError`, and the
    whole group is torn down: every child is ended and joined.  A rank
    whose parent is gone ends itself, so no rank outlives its group;
  * the CUDA kernels are built in the parent before the ranks start
    (`kernels.build.build_all`), so no two ranks compile one library;
  * launch counters (`kernels.group_aggregate.launches`) live in each
    process: `RankGroup.launches` reads every rank's.

Transport (``dist_backend``): ``"nccl"`` puts rank ``p`` on card ``p``
and needs ``P`` cards; with fewer it raises, naming ``--dist-backend
gloo``, and the code never switches backend by itself.  ``"gloo"`` on
the card puts every rank on card 0, and tensors stay on the card: a
probe on the H100 machine (torch 2.11.0+cu128, two gloo ranks on one
card) found that gloo takes every collective used here on CUDA tensors
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``
with SUM and MAX, on float32 and int32), so none is staged through host
memory.  On the CPU the backend is gloo.  Under NCCL each rank also
holds a gloo group over the same ranks for collectives on CPU tensors
(`compressed_psum` on the host).

The collective helpers (`all_gather_rows`, `reduce_scatter_rows`,
`all_reduce_`) run inside a rank, over the whole group or over the
process group of one mesh axis (``group=``).  With `collective_timing`
on they record each collective's span (CUDA events on the card, the host
clock on the CPU), so a step's time in collectives can be read apart
from the kernels' (`collective_ms`).  They also count, always, each
collective's operand bytes and calls by kind (`collective_bytes`), by
the reference's rule (`src/repro/launch/hlo_analysis.py:50`: the bytes
of the operand a rank sends in, each transfer counted once): an
all-gather counts this rank's slice, a reduce-scatter and an all-reduce
the whole tensor it puts in.  The dry-run
(`repro_torch.launch.dryrun_lib`) reads the same counter over a traced
step.

Axis groups (`AxisGroups`, for `repro_torch.launch.mesh`): the group's
ranks laid out row-major on a mesh of shape ``(..., data, model)``.
Every rank builds, in one order, one `torch.distributed` subgroup per
slice of each axis of size above 1 (the ranks that differ only in that
axis), so a collective "over ``model``" runs among the ranks of this
rank's ``model`` slice, in their order along the axis.  Axis groups take
tensors on the group's device.

Gradients through the axis collectives (`reduce_from`, `copy_to`,
`gather_from`, `scatter_to`: `torch.autograd.Function`s, timed like the
rest).  One convention, Megatron's: the loss a rank differentiates is
its batch rows' part of the global loss (the global loss is the sum of
the parts over the batch axes ``(pod, data)``), and every rank of a
``model`` slice holds the same value of it.  Then a tensor that every
model rank holds whole, and uses whole, carries its whole gradient on
each rank, and a tensor of which a model rank computes only a part of
the loss carries the gradient of that part.  The adjoints follow:

  * `reduce_from`, a sum over axes whose result every rank uses whole
    (a row-parallel output, the vocab-parallel embedding, routing
    statistics): backward is the identity;
  * `copy_to`, the identity into a region where each model rank computes
    a part (the input of a column-parallel layer, and a leaf replicated
    over ``model`` but read there: ``wk`` / ``wv`` / their biases and
    norms, of which a rank reads only some kv heads, the MoE ``router``;
    under sequence parallelism also the norm gains and biases of the
    sequence-split residual): backward sums over the axes, so the
    gradient of such a leaf is whole on every rank, not ``tp`` times it
    and not a part of it;
  * `gather_from`, an all-gather along a dim: backward is this rank's
    slice of the gradient summed over ``sum_grad`` (the FSDP gather over
    ``data`` sums: a reduce-scatter, in float32; the gather over
    ``model`` of a tensor used whole sums nothing: the slice);
  * `scatter_to`, a reduce-scatter along a dim (sequence parallelism's
    exit from a row-parallel layer): backward is the all-gather;
  * a local ``narrow`` of a whole leaf is autograd's own (zeros
    elsewhere), after a `copy_to` over the axes it is narrowed along.

After the backward a leaf's gradient is whole over ``model`` on every
rank; it still needs the sum over the batch axes its spec does not split
it over (a leaf split over ``data`` had its reduce-scatter).

CUDA tensors in a message cross by CUDA IPC (`torch.multiprocessing`'s
reductions): the receiving rank maps the sender's memory and copies
what it keeps, so tens of GB of weights reach the ranks at device-copy
speed.  The sender keeps the tensor alive until the call returns.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import io
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from multiprocessing.reduction import ForkingPickler
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing  # noqa: F401  registers the CUDA IPC reductions

__all__ = ["AxisGroups", "COLLECTIVE_KINDS", "DIST_BACKENDS", "Rank",
           "RankError", "RankGroup", "all_gather_rows", "all_reduce_",
           "check_dist_backend", "close_groups", "collective_bytes",
           "collective_bytes_by_group", "collective_ms",
           "collective_timing", "copy_to", "current_rank",
           "default_dist_backend", "from_wire", "gather_from", "reduce_from",
           "reduce_scatter_rows", "scatter_to", "shard_group", "to_wire"]

DIST_BACKENDS = ("nccl", "gloo")
INIT_TIMEOUT_S = 180.0
CALL_TIMEOUT_S = 600.0


class RankError(RuntimeError):
    """A rank raised, died or timed out; the group has been torn down."""


def default_dist_backend(device) -> str:
    """``"nccl"`` on the card, ``"gloo"`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_dist_backend(dist_backend: str, device, num_shards: int) -> None:
    """Raise unless ``dist_backend`` can run ``num_shards`` ranks on
    ``device``: NCCL needs one card per rank (`shard_mesh`'s refusal of
    too few devices)."""
    if dist_backend not in DIST_BACKENDS:
        raise ValueError(f"unknown dist backend {dist_backend!r}; one of "
                         f"{DIST_BACKENDS}")
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if dist_backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("dist backend nccl runs on the card only; on the "
                         "CPU pass --dist-backend gloo")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < num_shards:
        raise ValueError(
            f"dist backend nccl needs one card per shard: {num_shards} "
            f"shards, {have} card(s); pass --dist-backend gloo to run every "
            f"rank on card 0")


# ---------------------------------------------------------------------------
# wire format: numpy arrays (bfloat16 travels as its int16 bits)

def to_wire(t: Optional[torch.Tensor]):
    """A tensor as ``(numpy array, dtype name)`` for the pipe (None
    passes)."""
    if t is None:
        return None
    t = t.detach()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.cpu().numpy()
    # `ascontiguousarray` turns a 0-d array (a step counter) into (1,)
    return (np.ascontiguousarray(a) if a.ndim else a.copy()), name


def from_wire(w, device) -> Optional[torch.Tensor]:
    """Inverse of `to_wire`, on ``device``."""
    if w is None:
        return None
    arr, name = w
    t = torch.from_numpy(np.ascontiguousarray(arr) if arr.ndim
                         else np.array(arr))
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


# ---------------------------------------------------------------------------
# the pipe: pickles whose large arrays travel as files
#
# A `multiprocessing` pipe moves a few MB/s for messages of hundreds of MB
# (full reddit's sub-plans took 840 s on the H100 machine), so every array
# of at least `SPILL_MIN_BYTES` is written to a file in the group's
# temporary directory instead (page cache, GB/s) and read back, then
# deleted, by the one process that unpickles the message.

SPILL_MIN_BYTES = 1 << 20


def _load_spilled(path: str) -> np.ndarray:
    try:
        return np.load(path, allow_pickle=False)
    finally:
        os.unlink(path)


class _Pickler(ForkingPickler):
    def __init__(self, file, spill_dir: str):
        super().__init__(file, pickle.HIGHEST_PROTOCOL)
        self._spill_dir = spill_dir

    def reducer_override(self, obj):
        if (type(obj) is np.ndarray and obj.nbytes >= SPILL_MIN_BYTES
                and obj.dtype.kind in "biufc"):
            fd, path = tempfile.mkstemp(suffix=".npy", dir=self._spill_dir)
            with os.fdopen(fd, "wb") as f:
                np.save(f, obj, allow_pickle=False)
            return _load_spilled, (path,)
        return NotImplemented


def _send(conn, obj, spill_dir: str) -> None:
    buf = io.BytesIO()
    _Pickler(buf, spill_dir).dump(obj)
    conn.send_bytes(buf.getbuffer())


def _recv(conn):
    return pickle.loads(conn.recv_bytes())


# ---------------------------------------------------------------------------
# inside a rank

@dataclasses.dataclass
class Rank:
    """One rank's context: its index, the group size, its device, and
    ``state``, where the caller's objects live between calls (keyed by
    the caller)."""

    rank: int
    world: int
    device: torch.device
    host_group: Any = None          # gloo group for CPU tensors under NCCL
    state: dict = dataclasses.field(default_factory=dict)


_RANK: Optional[Rank] = None
_TIMING: Optional[list] = None      # [(start, end)] spans when timing is on


def current_rank() -> Rank:
    if _RANK is None:
        raise RuntimeError("not inside a rank process")
    return _RANK


def _group_for(t: torch.Tensor, group=None):
    """The process group for a collective on ``t``: ``group`` when given,
    else the default group, or inside a rank under NCCL the gloo side
    group for a CPU tensor."""
    if group is not None or _RANK is None:
        return group
    return None if t.is_cuda else _RANK.host_group


class _Span:
    def __enter__(self):
        if _TIMING is None:
            return self
        r = current_rank()
        if r.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _TIMING is None:
            return
        if isinstance(self.start, float):
            _TIMING.append((self.start, time.perf_counter()))
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _TIMING.append((self.start, end))


def collective_timing(on: bool) -> None:
    """Start (clearing earlier spans) or stop recording collective spans
    in this rank."""
    global _TIMING
    _TIMING = [] if on else None


def collective_ms() -> float:
    """Milliseconds spent in collectives since `collective_timing(True)`
    (synchronizes the card)."""
    if not _TIMING:
        return 0.0
    if isinstance(_TIMING[0][0], float):
        return sum(b - a for a, b in _TIMING) * 1e3
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in _TIMING)


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_BYTES = dict.fromkeys(COLLECTIVE_KINDS, 0)
_CALLS = dict.fromkeys(COLLECTIVE_KINDS, 0)
_BY_GROUP: dict = {}                # process group (None: world) -> bytes


def _count(kind: str, x: torch.Tensor, group) -> None:
    n = x.numel() * x.element_size()
    _BYTES[kind] += n
    _CALLS[kind] += 1
    _BY_GROUP[group] = _BY_GROUP.get(group, 0) + n


def collective_bytes(reset: bool = False) -> dict:
    """This process's collective operand bytes and calls by kind since the
    last reset, in the reference's form (``by_kind``, ``counts``,
    ``total_bytes``; `src/repro/launch/hlo_analysis.py:collective_bytes`);
    ``reset`` zeroes them after reading."""
    out = {"by_kind": dict(_BYTES), "counts": dict(_CALLS),
           "total_bytes": sum(_BYTES.values())}
    if reset:
        for k in COLLECTIVE_KINDS:
            _BYTES[k] = _CALLS[k] = 0
        _BY_GROUP.clear()
    return out


def collective_bytes_by_group() -> dict:
    """This process's collective operand bytes by process group (None:
    the default group) since the last reset."""
    return dict(_BY_GROUP)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (n, ...) stacked in rank order: (P n, ...), over
    the whole group or over ``group``."""
    import torch.distributed as dist
    g = _group_for(x, group)
    world = dist.get_world_size(g)
    x = x.contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    _count("all-gather", x, g)
    with _Span():
        dist.all_gather_into_tensor(out, x, group=g)
    return out


def reduce_scatter_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` (P n, ...) over the ranks (of ``group``) and keep this
    rank's n rows."""
    import torch.distributed as dist
    g = _group_for(x, group)
    world = dist.get_world_size(g)
    x = x.contiguous()
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not split over {world} "
                         f"ranks")
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    _count("reduce-scatter", x, g)
    with _Span():
        dist.reduce_scatter_tensor(out, x, group=g)
    return out


def all_reduce_(x: torch.Tensor, op: str = "sum",
                group=None) -> torch.Tensor:
    """In-place all-reduce of ``x`` (``op`` "sum" or "max") over the
    whole group or over ``group``; returns x."""
    import torch.distributed as dist
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    g = _group_for(x, group)
    _count("all-reduce", x, g)
    with _Span():
        dist.all_reduce(x, op=rop, group=g)
    return x


class AxisGroups:
    """Inside a rank: its place on a mesh of the group's ranks (row-major,
    ``shape`` over ``axes``) and the process groups of its axis slices.
    Built by every rank at once (`new_subgroups_by_enumeration` is a
    collective over the whole group), in one order."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self._grid = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.coords = {a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(rank, self._grid.shape))}
        self._groups: dict = {}
        for a in self.axis_names:
            self._group((a,))

    def _norm(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if a in self.shape)

    def size(self, axes) -> int:
        """Ranks along ``axes`` (a name or a tuple; missing axes count 1)."""
        return int(np.prod([self.shape[a] for a in self._norm(axes)]))

    def index(self, axes) -> int:
        """This rank's index along ``axes``, the first name major."""
        axes = self._norm(axes)
        if not axes:
            return 0
        return int(np.ravel_multi_index([self.coords[a] for a in axes],
                                        [self.shape[a] for a in axes]))

    def _group(self, axes: tuple):
        """The process group of this rank's slice along ``axes`` (None:
        the whole group), built on first use, by every rank at once."""
        if axes in self._groups:
            return self._groups[axes]
        import torch.distributed as dist
        if set(axes) == set(self.axis_names):
            grp = None
        else:
            dims = [self.axis_names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"axes {axes} are not in the mesh's order "
                                 f"{self.axis_names}")
            rest = [d for d in range(self._grid.ndim) if d not in dims]
            members = np.transpose(self._grid, rest + dims).reshape(
                -1, self.size(axes))
            grp, _ = dist.new_subgroups_by_enumeration(members.tolist())
        self._groups[axes] = grp
        return grp

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """In-place all-reduce of ``x`` over ``axes``; returns x."""
        axes = self._norm(axes)
        if self.size(axes) == 1:
            return x
        return all_reduce_(x, op, group=self._group(axes))

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' ``x`` along ``axes`` concatenated on ``dim``, in
        their order along the axes (contiguous: a gathered weight is
        used whole, and a strided one would be copied again)."""
        axes = self._norm(axes)
        if self.size(axes) == 1:
            return x
        if dim % x.dim() == 0:
            return all_gather_rows(x, group=self._group(axes))
        parts = all_gather_rows(x.unsqueeze(0), group=self._group(axes))
        return torch.cat(parts.unbind(0), dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        """``x`` summed over ``axes``, this rank's chunk of ``dim`` kept
        (chunks in the ranks' order along the axes)."""
        axes = self._norm(axes)
        if self.size(axes) == 1:
            return x
        out = reduce_scatter_rows(x.movedim(dim, 0), group=self._group(axes))
        return out.movedim(0, dim)

    def chunk(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's chunk of ``dim`` along ``axes`` (a local view)."""
        n = self.size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {axes} ({n} ranks)")
        c = x.shape[dim] // n
        return x.narrow(dim, self.index(axes) * c, c)


# ---------------------------------------------------------------------------
# differentiable collectives over an `AxisGroups` (the convention is in the
# module docstring)

def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axes), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, sum_grad):
        ctx.mesh, ctx.axes, ctx.dim, ctx.sum_grad = mesh, axes, dim, sum_grad
        ctx.dtype = x.dtype
        return mesh.all_gather(x, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        if ctx.sum_grad == axes:
            g = mesh.reduce_scatter(g.float(), axes, dim=dim)
        else:
            if ctx.sum_grad:
                g = mesh.all_reduce(g.float(), ctx.sum_grad)
            g = mesh.chunk(g, axes, dim)
        return g.to(ctx.dtype), None, None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.reduce_scatter(x, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g, ctx.axes, dim=ctx.dim), None, None,
                None)


def reduce_from(x: torch.Tensor, mesh: "AxisGroups", axes) -> torch.Tensor:
    """Sum ``x`` over ``axes``; backward the identity.  Without a
    gradient to carry it sums in place."""
    axes = mesh._norm(axes)
    if mesh.size(axes) == 1:
        return x
    if not _needs_grad(x):
        return mesh.all_reduce(x, axes)
    return _ReduceFrom.apply(x, mesh, axes)


def copy_to(x: torch.Tensor, mesh: "AxisGroups", axes) -> torch.Tensor:
    """``x`` as it is; backward sums the gradient over ``axes``."""
    axes = mesh._norm(axes)
    if mesh.size(axes) == 1 or not _needs_grad(x):
        return x
    return _CopyTo.apply(x, mesh, axes)


def gather_from(x: torch.Tensor, mesh: "AxisGroups", axes, dim: int, *,
                sum_grad=()) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axes``; backward this rank's
    slice of the gradient summed (in float32) over ``sum_grad``, a
    subset of ``axes`` (all of them: a reduce-scatter)."""
    axes = mesh._norm(axes)
    if mesh.size(axes) == 1:
        return x
    if not _needs_grad(x):
        return mesh.all_gather(x, axes, dim=dim)
    sum_grad = tuple(a for a in axes if a in mesh._norm(sum_grad))
    return _GatherFrom.apply(x, mesh, axes, dim % x.dim(), sum_grad)


def scatter_to(x: torch.Tensor, mesh: "AxisGroups", axes,
               dim: int) -> torch.Tensor:
    """Sum ``x`` over ``axes`` and keep this rank's chunk of ``dim``;
    backward the all-gather along ``dim``."""
    axes = mesh._norm(axes)
    if mesh.size(axes) == 1:
        return x
    if not _needs_grad(x):
        return mesh.reduce_scatter(x, axes, dim=dim)
    return _ScatterTo.apply(x, mesh, axes, dim % x.dim())


def _watch_parent(parent_pid: int) -> None:
    """End this rank when its parent is gone (reparented)."""
    while True:
        if os.getppid() != parent_pid:
            os._exit(3)
        time.sleep(0.5)


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               device_type: str, timeout_s: float, parent_pid: int,
               spill_dir: str, conn) -> None:
    global _RANK
    import warnings
    threading.Thread(target=_watch_parent, args=(parent_pid,),
                     daemon=True).start()
    # newer PyTorch renames the tensor collectives (`*_single`); the names
    # used here are the ones every supported version has
    warnings.filterwarnings("ignore", message=".*is deprecated. Please use",
                            category=FutureWarning)
    try:
        import torch.distributed as dist
        if device_type == "cuda":
            idx = rank if backend == "nccl" else 0
            torch.cuda.set_device(idx)
            device = torch.device("cuda", idx)
        else:
            device = torch.device("cpu")
            # the ranks share the host's cores with each other and with
            # whatever else runs there: one thread each
            torch.set_num_threads(1)
        timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=timeout)
        host_group = (dist.new_group(backend="gloo", timeout=timeout)
                      if backend == "nccl" else None)
        _RANK = Rank(rank=rank, world=world, device=device,
                     host_group=host_group)
        _send(conn, ("ok", None), spill_dir)
    except BaseException:
        _send(conn, ("error", traceback.format_exc()), spill_dir)
        return
    while True:
        try:
            data = conn.recv_bytes()
        except (EOFError, OSError):
            break
        try:
            msg = pickle.loads(data)
            if msg is None:
                break
            fn, args, drops = msg
            for key in drops:
                _RANK.state.pop(key, None)
            reply = ("ok", fn(_RANK, *args))
            # close the sender's CUDA IPC mappings before answering
            del msg, args
            buf = io.BytesIO()
            _Pickler(buf, spill_dir).dump(reply)
        except BaseException:
            buf = io.BytesIO()
            _Pickler(buf, spill_dir).dump(("error", traceback.format_exc()))
        try:
            conn.send_bytes(buf.getbuffer())
        except (EOFError, OSError, BrokenPipeError):
            break
    try:
        dist.destroy_process_group()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# the caller's side

def _r_launches(r: Rank, reset: bool) -> dict:
    from repro_torch.kernels import group_aggregate as ga
    from repro_torch.kernels import selective_scan as ss
    out = {**ga.launches, **ss.launches}
    if reset:
        ga.reset_launches()
        ss.reset_launches()
    return out


def _r_collectives(r: Rank, reset: bool) -> dict:
    return collective_bytes(reset)


def _r_drop(r: Rank, key) -> None:
    r.state.pop(key, None)
    if r.device.type == "cuda":
        torch.cuda.empty_cache()


def _r_memory(r: Rank, reset: bool) -> dict:
    """This rank's allocated and peak device GB (0 on the CPU)."""
    if r.device.type != "cuda":
        return {"allocated_gb": 0.0, "peak_gb": 0.0}
    out = {"allocated_gb": torch.cuda.memory_allocated(r.device) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated(r.device) / 1e9}
    if reset:
        torch.cuda.reset_peak_memory_stats(r.device)
    return out


_start_lock = threading.Lock()


def _spawn(ctx, **kw):
    """Start a spawned process that does not re-run the caller's main
    module (the ranks need nothing from it, and a script or a test
    runner without a ``__main__`` guard must still be able to start
    them)."""
    import multiprocessing.spawn as mp_spawn
    with _start_lock:
        orig = mp_spawn.get_preparation_data

        def without_main(name):
            d = orig(name)
            d.pop("init_main_from_name", None)
            d.pop("init_main_from_path", None)
            return d

        mp_spawn.get_preparation_data = without_main
        try:
            p = ctx.Process(**kw)
            p.start()
        finally:
            mp_spawn.get_preparation_data = orig
    return p


class RankGroup:
    """``num_shards`` rank processes under one `torch.distributed` group
    (see the module docstring).  Use `shard_group` to get one."""

    def __init__(self, num_shards: int, *, device="cuda",
                 dist_backend: Optional[str] = None,
                 timeout: float = CALL_TIMEOUT_S):
        from repro_torch.device import resolve_device
        dev = resolve_device(device)
        backend = dist_backend or default_dist_backend(dev)
        check_dist_backend(backend, dev, num_shards)
        self.num_shards = num_shards
        self.device_type = dev.type
        self.dist_backend = backend
        self.timeout = timeout
        self._keys = 0
        self._released: list = []
        self._closed = False
        self._pool_key = None
        self._conns, self._procs, self._tmp = [], [], None
        if dev.type == "cuda":
            # built once here: ranks load the libraries, never compile
            from repro_torch.kernels.build import build_all
            build_all()
        # all ranks share one host: the transports' bootstrap takes the
        # loopback interface unless the caller chose one
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        init_method = "file://" + os.path.join(self._tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        try:
            for r in range(num_shards):
                parent, child = ctx.Pipe()
                p = _spawn(
                    ctx, target=_rank_main, daemon=True,
                    args=(r, num_shards, backend, init_method, dev.type,
                          timeout, os.getpid(), self._tmp, child),
                    name=f"repro_torch-rank{r}")
                child.close()
                self._conns.append(parent)
                self._procs.append(p)
            self._collect(min(timeout, INIT_TIMEOUT_S) + 60.0, "start-up")
        except BaseException:
            self.close()
            raise

    @property
    def alive(self) -> bool:
        return not self._closed

    def new_key(self, prefix: str = "k") -> str:
        """A key no other user of this group holds (rank ``state``)."""
        self._keys += 1
        return f"{prefix}{self._keys}"

    def _collect(self, timeout: float, what: str) -> list:
        """Every rank's reply, in rank order; tears the group down and
        raises `RankError` on an error, a death or the timeout."""
        deadline = time.monotonic() + timeout
        out: list = [None] * self.num_shards
        pending = dict(enumerate(self._conns))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close(force=True)
                raise RankError(f"{what}: ranks {sorted(pending)} did not "
                                f"answer within {timeout:.0f}s; the group "
                                f"was torn down")
            waits = list(pending.values()) + [self._procs[r].sentinel
                                              for r in pending]
            ready = mpc.wait(waits, timeout=left)
            for r, conn in list(pending.items()):
                if conn in ready or self._procs[r].sentinel in ready:
                    try:
                        status, val = _recv(conn)
                    except (EOFError, OSError):
                        code = self._procs[r].exitcode
                        self.close(force=True)
                        raise RankError(f"{what}: rank {r} died (exit code "
                                        f"{code}); the group was torn down")
                    if status != "ok":
                        self.close(force=True)
                        raise RankError(f"{what}: rank {r} raised; the group "
                                        f"was torn down\n{val}")
                    out[r] = val
                    del pending[r]
        return out

    def run(self, fn: Callable, per_rank: Optional[Sequence[tuple]] = None,
            *args, timeout: Optional[float] = None) -> list:
        """``fn(rank_ctx, *args, *per_rank[r])`` on every rank ``r`` at
        once; the replies in rank order.  ``fn`` must be a module-level
        function (it is pickled by reference)."""
        if self._closed:
            raise RankError("the rank group is closed")
        name = getattr(fn, "__name__", str(fn))
        drops, self._released = tuple(self._released), []
        try:
            for r, conn in enumerate(self._conns):
                extra = tuple(per_rank[r]) if per_rank is not None else ()
                _send(conn, (fn, tuple(args) + extra, drops), self._tmp)
        except (OSError, BrokenPipeError) as e:
            self.close(force=True)
            raise RankError(f"{name}: a rank is gone ({e}); the group was "
                            f"torn down") from e
        return self._collect(self.timeout if timeout is None else timeout,
                             name)

    def launches(self, reset: bool = False) -> list:
        """Every rank's kernel launch counters (and zero them with
        ``reset``)."""
        return self.run(_r_launches, None, reset)

    def collectives(self, reset: bool = False) -> list:
        """Every rank's `collective_bytes` (and zero them with
        ``reset``)."""
        return self.run(_r_collectives, None, reset)

    def memory(self, reset: bool = False) -> list:
        """Every rank's allocated and peak device GB (and reset the peak
        with ``reset``)."""
        return self.run(_r_memory, None, reset)

    def drop(self, key) -> None:
        """Free what the ranks hold under ``key`` (no-op once closed)."""
        if not self._closed:
            self.run(_r_drop, None, key)

    def release(self, key) -> None:
        """Free what the ranks hold under ``key`` with the next call (safe
        from a finalizer: sends nothing now)."""
        if not self._closed:
            self._released.append(key)

    def close(self, force: bool = False) -> None:
        """End every rank and join it: politely (each leaves its process
        group), or at once with ``force`` (after a failure, when a rank
        may be stuck in a collective)."""
        if self._closed:
            return
        self._closed = True
        if not force:
            for conn in self._conns:
                try:
                    _send(conn, None, self._tmp)
                except (OSError, BrokenPipeError):
                    pass
            deadline = time.monotonic() + 5.0
            for p in self._procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
        if _POOL.get(self._pool_key) is self:
            del _POOL[self._pool_key]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_POOL: dict = {}


def shard_group(num_shards: int, *, device="cuda",
                dist_backend: Optional[str] = None,
                timeout: float = CALL_TIMEOUT_S) -> RankGroup:
    """The live `RankGroup` of ``num_shards`` ranks on ``device`` over
    ``dist_backend`` (default: `default_dist_backend`), started when
    there is none: the counterpart of ``shard_mesh``.  Groups are kept
    for reuse until `close_groups` (or exit); a group torn down by a
    failure is replaced on the next call.  Raises when NCCL is asked for
    with fewer cards than shards."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    backend = dist_backend or default_dist_backend(dev)
    check_dist_backend(backend, dev, num_shards)
    key = (num_shards, dev.type, backend)
    grp = _POOL.get(key)
    if grp is None or not grp.alive:
        grp = RankGroup(num_shards, device=dev, dist_backend=backend,
                        timeout=timeout)
        grp._pool_key = key
        _POOL[key] = grp
    grp.timeout = timeout
    return grp


def close_groups(keep: Sequence[RankGroup] = ()) -> None:
    """End every pooled group's ranks but those in ``keep``."""
    for key, grp in list(_POOL.items()):
        if not any(grp is k for k in keep):
            grp.close()
            _POOL.pop(key, None)


atexit.register(close_groups)
