"""Device ms a step of the kernels launched under `Optimizer.step#...`."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.per_call_ms(
        trace, readers.in_spans(trace, lambda n: n.startswith(readers.OPTIMIZER)), ctx)
