"""Device ms a step of host-to-device copies (the batch and its ground
truth)."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.per_call_ms(trace, readers.h2d_copies(trace), ctx)
