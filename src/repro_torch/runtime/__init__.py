"""Runtime substrate: checkpoint/restart and failure injection."""
from repro_torch.runtime.checkpoint import (AsyncCheckpointer,
                                            CheckpointError, available_steps,
                                            latest_step, restore_checkpoint,
                                            save_checkpoint)
from repro_torch.runtime.trainer import (FailureInjector, SimulatedFailure,
                                         Trainer, TrainerConfig)

__all__ = ["AsyncCheckpointer", "CheckpointError", "available_steps",
           "latest_step", "restore_checkpoint", "save_checkpoint",
           "FailureInjector", "SimulatedFailure", "Trainer", "TrainerConfig"]
