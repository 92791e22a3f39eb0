"""Target-hardware constants (NVIDIA H100 SXM) used by the analytical
model, the tuner's feasibility check and the roofline bounds.

Port of `src/repro/hw.py`: the port targets Hopper, so the spec below
replaces the reference's accelerator record.  Every figure is from
NVIDIA's H100 data sheet (SXM part, dense rates, full 700 W power limit)
and the Hopper tuning guide, and the special-function rate from the CUDA C++
Programming Guide's arithmetic-instruction throughput table; none is a
measurement.  A card set below
700 W runs slower under load — `chip_smoke.py` prints the card's power
limit beside every time it reports.
"""
from __future__ import annotations

import dataclasses

__all__ = ["GPUSpec", "H100_SXM"]


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    num_sms: int
    smem_per_block: int         # bytes of shared memory one block may use
    hbm_bytes: float            # device memory capacity
    hbm_bw: float               # bytes/s
    peak_flops_f32: float       # FLOP/s on the CUDA cores (FMA = 2 FLOP)
    peak_flops_bf16: float      # FLOP/s on the tensor cores, dense
    # exp/log results per second on the special-function units: results
    # per clock per SM x SMs x boost clock
    peak_sfu: float
    smem_per_sm: int            # bytes of shared memory one SM holds


H100_SXM = GPUSpec(
    name="h100_sxm",
    num_sms=132,
    smem_per_block=232_448,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    peak_flops_f32=67e12,
    peak_flops_bf16=989e12,
    # 16 exp2/log2/rsqrt results per clock per SM on compute capability 9.0
    # (CUDA C++ Programming Guide, "Arithmetic Instructions" throughput
    # table), over 132 SMs at the 1.98 GHz boost clock: 4.18e12 per second
    peak_sfu=16 * 132 * 1.98e9,
    # 228 KB a multiprocessor (Hopper tuning guide)
    smem_per_sm=233_472,
)
