"""Device ms a step of the step's other kernels: launched in the step on
its own thread, outside the forward, the backward and the optimizer (the
matcher, the four losses, the schedule and the batch's casts)."""
from benchmark.core import readers


def read(trace, ctx):
    outside = trace.spans(lambda n: n == readers.FORWARD or n.startswith(readers.OPTIMIZER)
                          or n.startswith(readers.BACKWARD))
    calls = trace.spans(lambda n: n == readers.CALL)
    picked = []
    for e in trace.kernels():
        where = trace.launch.get(id(e))
        if where and calls.holding(*where) is not None and outside.holding(*where) is None:
            picked.append(e)
    return readers.per_call_ms(trace, picked, ctx)
