"""Device ms a call of the kernels launched inside the backbone's forward."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.per_call_ms(trace, readers.in_spans(trace, lambda n: n == readers.BACKBONE),
                               ctx)
