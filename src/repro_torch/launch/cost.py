"""Per-op cost of one traced rank program: FLOPs, bytes, collectives,
memory and the three roofline terms.

Port of `src/repro/launch/hlo_cost.py` (`module_cost` :431, `HLOCost`)
and `src/repro/launch/hlo_analysis.py` (`collective_bytes` :50,
`memory_summary` :94, `roofline_terms` :112).  The reference reads a
compiled XLA module's text; the port has no compiled program, so it
counts the ops one rank runs as they run: `CostCounter` is a
`TorchDispatchMode` over the step, on real tensors or, in the dry-run,
on fake ones (`torch._subclasses.fake_tensor.FakeTensorMode`, which
allocates nothing).  The rules:

  * FLOPs.  Products and attention (``mm``, ``addmm``, ``bmm``,
    convolutions, the scaled-dot-product kernels and their backwards)
    take `torch.utils.flop_counter`'s registered formulas (2 per
    multiply-add); elementwise ops (those tagged pointwise, dtype
    conversions and copies) 1 FLOP an output element and reductions 1
    an input element, as the reference counts elementwise HLO ops and
    reduces; the scan kernel its own figure
    (`repro_torch.kernels.selective_scan.kernel_cost`, told through
    ``cost_sinks``); data movement (cat, index, gather, scatter),
    views and allocations 0.
  * Bytes accessed.  Each op's input and output tensors' bytes (a
    view's bytes, not its storage's), views, allocations and
    collectives 0; ``copy_`` / ``fill_`` / ``zero_`` do not read their
    destination.  Eager PyTorch runs every op as its own kernel, so
    this is each op's traffic to device memory (less what the L2
    catches), not a fused program's: the counterpart of the
    reference's bytes at fusion boundaries.
  * Collectives.  `repro_torch.distributed.ranks.collective_bytes`
    over the counted span: operand bytes by kind, each transfer once,
    and by process group (so the dry-run can price each mesh axis on
    its own link).
  * Memory.  A live-storage tracker: every storage an op creates is
    counted (rounded up to `ALLOC_ROUND`, the caching allocator's
    block) from its creation until it is freed; ``peak_bytes`` is the
    most live at once.  Storages that exist before the span (the
    arguments, first seen as an op's input; an in-place update of one
    allocates nothing) are the caller's to count (`memory_summary`).
    ``gloo_peak_bytes`` adds the one term a trace cannot see that a
    measurement showed: gloo's reduce-scatter on card tensors stages a
    copy of its operand on the card while it runs (`GLOO_STAGING`);
    NCCL reduces in place.

Module-top imports are stdlib and torch only.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.hw import H100_SXM, GPUSpec

__all__ = ["ALLOC_ROUND", "CostCounter", "GLOO_STAGING", "OpCost",
           "alloc_bytes", "memory_summary", "roofline_terms",
           "tensor_bytes"]

# the CUDA caching allocator rounds every block up to 512 bytes
ALLOC_ROUND = 512
# c10d ops whose gloo implementation copies their operand on the card
GLOO_STAGING = ("_reduce_scatter_base_", "reduce_scatter_")

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "var_mean", "std_mean", "logsumexp", "norm",
               "linalg_vector_norm", "_softmax", "_log_softmax", "argmax",
               "argmin", "any", "all", "cumsum", "cumprod", "topk", "sort"}
_ELEMENTWISE = {"_to_copy", "copy_", "clone"}
_ALLOCATIONS = {"empty", "empty_strided", "new_empty", "new_empty_strided",
                "empty_like"}
_FREE = {"_unsafe_view", "detach", "alias", "lift_fresh"}
_NO_READ_DEST = {"copy_", "fill_", "zero_"}
_LIFTS = {"lift_fresh", "lift_fresh_copy", "lift"}
# collectives (counted at the wrappers) and metadata queries move nothing
_SKIP_NS = ("c10d", "prim")


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def alloc_bytes(nbytes: int) -> int:
    """``nbytes`` as the caching allocator holds them."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(x, out=None) -> list:
    """The tensors in ``x`` (a tensor, or tuples / lists / dicts of
    them and of other values)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (tuple, list, dict)):
                _tensors(v, out)
    elif isinstance(x, dict):
        _tensors(list(x.values()), out)
    return out


@dataclasses.dataclass
class OpCost:
    """One op's totals over the span."""

    calls: int = 0
    flops: int = 0
    bytes: int = 0


class CostCounter(TorchDispatchMode):
    """Counts the ops run inside ``with CostCounter() as c:`` (see the
    module docstring).  After the block: ``flops``, ``product_flops``
    (the products and attention alone, what `torch.profiler`'s
    ``with_flops`` counts), ``bytes_accessed``, ``peak_bytes``,
    ``gloo_peak_bytes``, ``collectives`` (the reference's ``by_kind`` /
    ``counts`` / ``total_bytes``), ``collective_by_group`` (process group
    -> bytes; None is the whole world) and ``ops`` (op name ->
    `OpCost`)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.product_flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.gloo_peak_bytes = 0
        self.ops: dict = {}
        self.collectives: dict = {}
        self.collective_by_group: dict = {}
        self._seen = weakref.WeakSet()
        self._kinds: dict = {}          # OpOverload -> how it is counted

    # -- memory --------------------------------------------------------
    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, ins: list, outs: list) -> None:
        """Count the storages ``outs`` bring that no op has shown yet.  A
        storage first seen among an op's inputs was made outside the span
        (an argument) and is not counted, so an in-place op or a copy
        into an argument allocates nothing."""
        for t in ins:
            self._seen.add(t.untyped_storage())
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = alloc_bytes(st.nbytes())
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)

    # -- counts ------------------------------------------------------------
    def _add(self, name: str, flops: int, nbytes: int) -> None:
        op = self.ops.get(name)
        if op is None:
            op = self.ops[name] = OpCost()
        op.calls += 1
        op.flops += flops
        op.bytes += nbytes
        self.flops += flops
        self.bytes_accessed += nbytes

    def _kernel(self, name: str, flops: int, nbytes: int) -> None:
        """The scan kernel's own figure, told by its fake path."""
        self._add(name, int(flops), int(nbytes))

    def __enter__(self):
        from repro_torch.distributed import ranks
        from repro_torch.kernels import selective_scan
        self._coll0 = ranks.collective_bytes()
        self._group0 = ranks.collective_bytes_by_group()
        selective_scan.cost_sinks.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.distributed import ranks
        from repro_torch.kernels import selective_scan
        out = super().__exit__(*exc)
        self.gloo_peak_bytes = max(self.gloo_peak_bytes, self.peak_bytes)
        selective_scan.cost_sinks.remove(self._kernel)
        now = ranks.collective_bytes()
        self.collectives = {
            "by_kind": {k: now["by_kind"][k] - self._coll0["by_kind"][k]
                        for k in now["by_kind"]},
            "counts": {k: now["counts"][k] - self._coll0["counts"][k]
                       for k in now["counts"]},
            "total_bytes": now["total_bytes"] - self._coll0["total_bytes"]}
        self.collective_by_group = {
            g: n - self._group0.get(g, 0)
            for g, n in ranks.collective_bytes_by_group().items()
            if n - self._group0.get(g, 0)}
        return out

    # -- every op --------------------------------------------------------
    def _kind(self, func) -> str:
        """How ``func`` is counted: "skip" (collectives, metadata), "free"
        (views, allocations: memory only), "product", "reduce",
        "pointwise" or "move" (bytes only)."""
        kind = self._kinds.get(func)
        if kind is not None:
            return kind
        name = func.overloadpacket.__name__
        if getattr(func, "namespace", "aten") in _SKIP_NS:
            kind = "skip"
        elif func.is_view or name in _FREE or name in _ALLOCATIONS:
            kind = "free"
        elif func.overloadpacket in self._formulas:
            kind = "product"
        elif name in _REDUCTIONS:
            kind = "reduce"
        elif torch.Tag.pointwise in func.tags or name in _ELEMENTWISE:
            kind = "pointwise"
        else:
            kind = "move"
        self._kinds[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = self._kind(func)
        if kind == "skip":
            if func.overloadpacket.__name__ in GLOO_STAGING:
                staged = max(tensor_bytes(t) for t in _tensors(args))
                self.gloo_peak_bytes = max(self.gloo_peak_bytes,
                                           self.live_bytes
                                           + alloc_bytes(staged))
            return out
        outs = _tensors(out)
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        name = func.overloadpacket.__name__
        # `torch.tensor(...)` made its input just now, outside any op
        self._track([] if name in _LIFTS else ins, outs)
        if kind == "free":
            return out
        flops = 0
        if kind == "product":
            flops = int(self._formulas[func.overloadpacket](
                *args, **kwargs, out_val=out))
            self.product_flops += flops
        elif kind == "reduce":
            flops = ins[0].numel() if ins else 0
        elif kind == "pointwise":
            flops = sum(t.numel() for t in outs)
        if name in _NO_READ_DEST and ins:
            ins = ins[1:]
        self._add(name, flops, sum(t.numel() * t.element_size()
                                   for t in ins + outs))
        return out


def memory_summary(argument_bytes: int, peak_bytes: int) -> dict:
    """The counterpart of `memory_summary` (hlo_analysis :94): the rank's
    arguments (parameters, moments, batch, cache), the peak of the
    step's own live tensors on top of them, their sum, and whether it
    fits the card's memory (`H100_SXM.hbm_bytes`)."""
    total = int(argument_bytes) + int(peak_bytes)
    return {"argument_bytes": int(argument_bytes),
            "peak_bytes": int(peak_bytes), "total_bytes": total,
            "hbm_bytes": int(H100_SXM.hbm_bytes),
            "fits": total <= H100_SXM.hbm_bytes}


def roofline_terms(*, flops: float, bytes_accessed: float,
                   collective_total_bytes: float, num_chips: int,
                   hw: GPUSpec = H100_SXM, bf16: bool = True,
                   link_bw: Optional[float] = None) -> dict:
    """The three roofline terms in seconds, with the reference's
    signature and keys (hlo_analysis :112):

      compute    = FLOPs / (chips * peak)
      memory     = bytes / (chips * hbm_bw)
      collective = collective_bytes / (chips * link_bw)

    Per-rank figures go in with ``num_chips=1``.  ``link_bw`` defaults
    to the card's link within a node (``hw.link_bw_intra``); the dry-run
    passes the rate its axes' bytes see on their own links."""
    peak = hw.peak_flops_bf16 if bf16 else hw.peak_flops_f32
    bw = hw.link_bw_intra if link_bw is None else link_bw
    t_compute = flops / (num_chips * peak)
    t_memory = bytes_accessed / (num_chips * hw.hbm_bw)
    t_collective = collective_total_bytes / (num_chips * bw)
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_collective),
    }
