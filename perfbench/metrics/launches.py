"""Device kernels launched a unit (a step or a request), counted in the profiler's trace."""
from perfbench.metrics import _device


def read(run):
    return _device.launches(run)
