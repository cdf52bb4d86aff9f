"""The share of the traced slice in which no kernel, copy or set ran on
the device: 1 - (union of device intervals) / the slice's wall time."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.idle_percent(trace)
