"""Synthetic graphs, CSR structure, graph deltas and ego-graph extraction
(numpy)."""
