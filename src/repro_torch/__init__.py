"""GNNAdvisor on Hopper: the PyTorch + CUDA port of the `repro` package.

The package mirrors `src/repro/` module for module (each module names the
reference file it is held against) and never imports JAX or `repro`.
Backends: ``"cuda"`` runs the hand-written kernels under
`repro_torch/kernels/csrc/` (the default), ``"torch"`` runs their plain
PyTorch versions.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
