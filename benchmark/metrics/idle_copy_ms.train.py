"""Device-idle ms a step while the program's innermost span on the calling
thread was `yolact.train.copy`: the host pinning and handing the batch over."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.idle_ms(trace, program_spans.TRAIN_COPY, ctx)
