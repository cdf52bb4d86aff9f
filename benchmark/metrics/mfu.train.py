"""The whole step's share of the card's bf16 peak: the reference's training
forward and backward operations at the cell's shapes (no recompute), times
the steps of the run's untraced window, over its wall time, over 989 TFLOP/s."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.mfu_percent(ctx)
