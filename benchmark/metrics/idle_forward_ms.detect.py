"""Device-idle ms a call while the program's innermost span on the calling
thread was `yolact.detect.forward` (the swin glue's own spans left out): the
host dispatching the network slower than the device runs it."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.idle_ms(trace, program_spans.DETECT_FORWARD, ctx)
