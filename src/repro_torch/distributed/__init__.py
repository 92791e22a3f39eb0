"""Distribution substrate, single-device half: micro-batched gradient
accumulation.  The mesh half waits for ROADMAP Queue 1 item 5."""
from repro_torch.distributed.accumulate import (accumulate_gradients,
                                                split_batch)

__all__ = ["accumulate_gradients", "split_batch"]
