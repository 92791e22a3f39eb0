"""Models: GNNs (GCN, GIN, GAT) on the aggregation engine, and the
Mamba language model (`lm.py`)."""
