"""Fused Mamba-1 selective scan on Hopper: the wrapper of the CUDA kernel.

Port of `src/repro/kernels/selective_scan.py:selective_scan_pallas` (:82,
`pl.pallas_call` at :102, body `_kernel` :36).  The kernel,
`csrc/selective_scan.cu`, takes the pre-activation streams (``xc`` after
the conv and silu, ``dt_raw`` before softplus, the B and C streams) and
computes ``y_t = C_t . h_t + D xc_t`` with ``h_t = exp(dt_t A) h_{t-1} +
dt_t xc_t B_t``: a thread per (b, d) channel holds its N states in
registers (2 lanes a channel when the grid would leave SMs idle; the
launch decides from the shape), and the next chunk's inputs are copied
into shared memory while the thread walks this one; the source states its
bound, mapping and error budget.  The reference's ``chunk`` / ``dt_width`` are VMEM
tiling: the result does not depend on them and the kernel has neither.

Dispatch is by device and nothing else: a CUDA tensor launches the kernel
(or the call raises; there is no fallback), a CPU tensor runs the plain
version (`repro_torch.kernels.ref.selective_scan_ref`).  Every launch and
every plain call adds one to its count in `launches`.  The kernel has no
backward, as the reference's Pallas kernel has none: on either device the
wrapper raises `NotImplementedError` when grad mode is on and an input
requires a gradient (training takes the chunked path, ``fused_scan="off"``).

Fake tensors (`torch._subclasses.fake_tensor`, the dry-run's) stand for
card tensors and hold no memory: on either device, after the same
argument checks, the wrapper returns an empty (B, S, d_inner) float32
without building or launching anything and adds to no count; it tells
each callable in `cost_sinks` the kernel's work instead (`kernel_cost`),
which `repro_torch.launch.cost` prices.  Only a fake tensor takes that
branch: a real CUDA tensor still launches or raises.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import bind, check_arg, raise_on
from repro_torch.kernels.ref import selective_scan_ref

__all__ = ["KERNEL", "PLAIN", "cost_sinks", "kernel_cost", "launches",
           "refuse_grad", "reset_launches", "selective_scan",
           "selective_scan_plain"]

KERNEL = "selective_scan"
PLAIN = "selective_scan_ref"
MAX_STATE = 32                 # states per channel the kernel holds
MAX_BATCH = 65535              # grid.y

launches: Dict[str, int] = {KERNEL: 0, PLAIN: 0}
# callables ``sink(name, flops, nbytes)`` told of each fake-tensor call
cost_sinks: List[Callable] = []


def kernel_cost(bsz: int, seq: int, di: int, n: int) -> tuple:
    """``(flops, bytes)`` of one call, as the kernel table's bound counts
    them: each float32 input read once and ``y`` written once, about 7
    FLOP per (b, t, d, n)."""
    nbytes = 4 * (3 * bsz * seq * di + 2 * bsz * seq * n + di * n + 2 * di)
    return 7 * bsz * seq * di * n, nbytes


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires a
    gradient: the fused scan has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{KERNEL} has no backward (the reference's Pallas scan has "
            f"none either); train Mamba layers on the chunked path "
            f"(MambaParams(fused_scan='off')) or call under torch.no_grad()")


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def selective_scan_plain(xc, dt_raw, b, c, a_log, dt_bias,
                         d_skip) -> torch.Tensor:
    """The plain PyTorch version on any device, counted in `launches`."""
    launches[PLAIN] += 1
    return selective_scan_ref(xc, dt_raw, b, c, a_log, dt_bias, d_skip)


def selective_scan(xc: torch.Tensor, dt_raw: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a_log: torch.Tensor,
                   dt_bias: torch.Tensor, d_skip: torch.Tensor
                   ) -> torch.Tensor:
    """Fused selective scan.

    xc, dt_raw: (B, S, d_inner); b, c: (B, S, N) with N <= 32; a_log:
    (d_inner, N); dt_bias, d_skip: (d_inner,); all float32, contiguous and
    on one device.  Returns y (B, S, d_inner) float32.  Raises
    `NotImplementedError` under autograd (see the module docstring)."""
    refuse_grad(xc, dt_raw, b, c, a_log, dt_bias, d_skip)
    fake = _is_fake(xc)
    if not xc.is_cuda and not fake:
        return selective_scan_plain(xc, dt_raw, b, c, a_log, dt_bias, d_skip)
    if xc.dim() != 3 or b.dim() != 3:
        raise ValueError(f"xc and b must be 3-D, got {tuple(xc.shape)} and "
                         f"{tuple(b.shape)}")
    bsz, seq, di = xc.shape
    n = b.shape[-1]
    dev, f32 = xc.device, torch.float32
    check_arg("xc", xc, f32, (bsz, seq, di), dev)
    check_arg("dt_raw", dt_raw, f32, (bsz, seq, di), dev)
    check_arg("b", b, f32, (bsz, seq, n), dev)
    check_arg("c", c, f32, (bsz, seq, n), dev)
    check_arg("a_log", a_log, f32, (di, n), dev)
    check_arg("dt_bias", dt_bias, f32, (di,), dev)
    check_arg("d_skip", d_skip, f32, (di,), dev)
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{KERNEL} holds 1..{MAX_STATE} states per channel, "
                         f"got N={n}")
    if bsz > MAX_BATCH:
        raise ValueError(f"{KERNEL} takes at most {MAX_BATCH} batch rows, "
                         f"got {bsz}")
    y = torch.empty((bsz, seq, di), dtype=f32, device=dev)
    if fake:
        flops, nbytes = kernel_cost(bsz, seq, di, n)
        for sink in cost_sinks:
            sink(KERNEL, flops, nbytes)
        return y
    if y.numel() == 0:
        return y
    lib = build.load(KERNEL)
    fn = bind(lib, "repro_selective_scan")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    i = ctypes.c_int
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        code = fn(ptr(xc), ptr(dt_raw), ptr(b), ptr(c), ptr(a_log),
                  ptr(dt_bias), ptr(d_skip), ptr(y), i(bsz), i(seq), i(di),
                  i(n), stream)
    raise_on(lib, code, KERNEL)
    launches[KERNEL] += 1
    return y
