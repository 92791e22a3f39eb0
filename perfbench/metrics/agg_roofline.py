"""Percent of the aggregation kernels' device time that the least time of the aggregation work (_work.py) would take."""
from perfbench.metrics import _device


def read(run):
    return _device.agg_roofline(run)
