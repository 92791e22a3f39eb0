"""The paper's own benchmark configurations: GCN and GIN (§8.1.1).

GCN: 2 layers, hidden 16 (the paper's standard Kipf config).
GIN: 5 layers, hidden 64 (the paper's §8.7 case study uses 5 layers; 64 is
the common GIN hidden size in its Fig. 13 sweep range).

Port of `src/repro/configs/paper_gnn.py`: the same values, on the port's
`GNNConfig` (its backend and device keep their defaults: the card).
"""
from __future__ import annotations

from repro_torch.models.gnn import GNNConfig

__all__ = ["gcn_config", "gin_config", "GNN_ARCHS"]


def gcn_config(in_dim: int = 128, num_classes: int = 8) -> GNNConfig:
    return GNNConfig(arch="gcn", in_dim=in_dim, hidden_dim=16,
                     num_classes=num_classes, num_layers=2)


def gin_config(in_dim: int = 128, num_classes: int = 8) -> GNNConfig:
    return GNNConfig(arch="gin", in_dim=in_dim, hidden_dim=64,
                     num_classes=num_classes, num_layers=5)


GNN_ARCHS = {"gcn": gcn_config, "gin": gin_config}
