"""Percent of the traced window in which no operation ran on the device."""
from perfbench.metrics import _device


def read(run):
    return _device.idle_pct(run)
