"""Device ms a unit (a step or a request) in every other kernel, copy and memset."""
from perfbench.metrics import _device


def read(run):
    return _device.dense_ms(run)
