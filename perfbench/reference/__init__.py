"""Plain PyTorch reference of the benchmark's models (imports nothing of
the port)."""
