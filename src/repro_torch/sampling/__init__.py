"""Neighbor-sampled mini-batch GNN training.

Port of `src/repro/sampling/`: `neighbor` builds per-layer bipartite
message-flow blocks by seeded fanout sampling; `loader` streams padded,
planned, device-resident batches through a prefetch thread and runs the
eager train step; `ShardedSampledTrainStep` runs it data-parallel over
a rank group.
"""
from repro_torch.sampling.loader import (LoaderConfig, SampledLoader,
                                         SampledTrainStep,
                                         ShardedSampledTrainStep, TrainBatch)
from repro_torch.sampling.neighbor import (Block, SampledBatch,
                                           block_aggregate_ref,
                                           sample_blocks, sample_frontier)

__all__ = [
    "Block",
    "SampledBatch",
    "sample_frontier",
    "sample_blocks",
    "block_aggregate_ref",
    "LoaderConfig",
    "TrainBatch",
    "SampledLoader",
    "SampledTrainStep",
    "ShardedSampledTrainStep",
]
