"""Data substrate: deterministic sharded synthetic pipelines."""
from repro_torch.data.pipeline import (PipelineConfig, TokenPipeline,
                                       make_lm_batch)

__all__ = ["PipelineConfig", "TokenPipeline", "make_lm_batch"]
