"""Device-idle ms a call while the program's innermost span on the calling
thread was `yolact.detect.copy`: the host handing the batch over."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.idle_ms(trace, program_spans.DETECT_COPY, ctx)
