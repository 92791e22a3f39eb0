"""Synthetic graphs, CSR structure and ego-graph extraction (numpy)."""
