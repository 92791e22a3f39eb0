"""Distribution substrate: micro-batched gradient accumulation
(`accumulate`), the rank group that stands for the reference's device
mesh (`ranks`: ``P`` spawned processes under `torch.distributed`, driven
from one caller, with per-axis process groups for a named mesh),
multi-rank halo-exchange graph execution (`graph_shard`) and the LM
mesh's specs and placements (`sharding`; the mesh is
`repro_torch.launch.mesh`, the elastic re-shard
`repro_torch.runtime.elastic`; the rank side of the LM steps is
`repro_torch.nn.tensor_parallel`, with the differentiable collectives of
`ranks` and `accumulate`'s rank-side micro-batching for the sharded
train step)."""
from repro_torch.distributed.accumulate import (accumulate_gradients,
                                                split_batch)
from repro_torch.distributed.graph_shard import (ShardedExecutor,
                                                 ShardedModel,
                                                 ShardedTrainStep,
                                                 gather_rows,
                                                 local_step_value_and_grad,
                                                 make_sharded_logits_fn,
                                                 make_sharded_train_step)
from repro_torch.distributed.ranks import (DIST_BACKENDS, RankError,
                                           RankGroup, check_dist_backend,
                                           close_groups,
                                           default_dist_backend, shard_group)

__all__ = ["DIST_BACKENDS", "RankError", "RankGroup", "ShardedExecutor",
           "ShardedModel", "ShardedTrainStep", "accumulate_gradients",
           "check_dist_backend", "close_groups", "default_dist_backend",
           "gather_rows", "local_step_value_and_grad",
           "make_sharded_logits_fn", "make_sharded_train_step",
           "shard_group", "split_batch"]
