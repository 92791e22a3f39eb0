"""The port's kernels (CUDA), their plain versions and wrappers: group
aggregation and its edge gradient, and the Mamba-1 selective scan."""
