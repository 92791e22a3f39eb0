"""Group-aggregation kernels (CUDA), their plain versions and wrappers."""
