"""Percent of the float32 peak that the model FLOPs of a unit (a step or a request) reach over its wall time in the traced window."""
from perfbench.metrics import _device


def read(run):
    return _device.mfu(run)
