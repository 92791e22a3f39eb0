"""Device ms a unit (a step or a request) in the aggregation kernels (names in agg_kernels/*.txt)."""
from perfbench.metrics import _device


def read(run):
    return _device.agg_ms(run)
