"""Device ms a step of the kernels the autograd engine launched (the plain
recompute of the swin kernels' backward with them)."""
from benchmark.core import readers


def read(trace, ctx):
    return readers.per_call_ms(
        trace, readers.in_spans(trace, lambda n: n.startswith(readers.BACKWARD)), ctx)
