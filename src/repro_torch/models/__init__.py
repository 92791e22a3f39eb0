"""GNN models (GCN, GIN, GAT) on the aggregation engine."""
