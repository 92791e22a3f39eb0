"""Optimizer substrate: AdamW, schedules, clipping."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, adamw_update_,
                                     clip_by_global_norm, cosine_schedule,
                                     global_norm, linear_warmup,
                                     opt_state_from_jax)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "linear_warmup", "opt_state_from_jax"]
