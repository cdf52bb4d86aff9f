"""Device ms a call of the kernels launched in the call after its forward
ended: decode, fast NMS with the suppression kernel, the masks."""
from benchmark.core import readers


def read(trace, ctx):
    forwards = trace.named(readers.FORWARD)
    calls = trace.spans(lambda n: n == readers.CALL)
    picked = []
    for e in trace.kernels():
        where = trace.launch.get(id(e))
        call = calls.holding(*where) if where else None
        if call is None:
            continue
        ends = [f.end for f in forwards if call.start <= f.start <= call.end]
        if ends and where[0] > max(ends):
            picked.append(e)
    return readers.per_call_ms(trace, picked, ctx)
