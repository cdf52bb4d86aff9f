"""Device ms a step of the kernels launched inside the model's training
forward (the semantic head with it)."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.per_call_ms(trace, readers.in_spans(trace, lambda n: n == readers.FORWARD), ctx)
