"""The whole call's share of the card's bf16 peak: the reference forward's
operations at the cell's shapes, times the calls of the run's untraced
window, over its wall time, over 989 TFLOP/s."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.mfu_percent(ctx)
