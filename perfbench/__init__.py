"""Benchmark of the PyTorch and CUDA port (`repro_torch`).

`run.py` runs one cell of `BENCHMARK.json` once.  Everything a cell is
made of is found by name: configurations in `configs/`, traffic mixes in
`mixes/` (each names its driver in `traffic/`), per-layer metric readers
in `metrics/`, the limits that decide `correct` in `limits/`.  The plain
reference in `reference/` imports nothing of the port.
"""
