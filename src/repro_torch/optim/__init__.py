"""Optimizer substrate: AdamW, schedules, clipping, int8 error-feedback
compression."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, adamw_update_,
                                     clip_by_global_norm, cosine_schedule,
                                     global_norm, linear_warmup,
                                     opt_state_from_jax)
from repro_torch.optim.compression import (compress_decompress,
                                           dequantize_int8, ef_init,
                                           quantize_int8)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "linear_warmup", "opt_state_from_jax",
           "compress_decompress", "dequantize_int8", "ef_init",
           "quantize_int8"]
