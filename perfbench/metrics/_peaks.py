"""NVIDIA H100 SXM peaks, a copy of the port's `hw.py` data-sheet figures
(dense rates at the full 700 W limit); the yardstick keeps its own."""
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # CUDA cores, no TF32: the configurations' products
