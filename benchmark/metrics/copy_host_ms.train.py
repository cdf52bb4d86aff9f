"""Host ms a step of the program's `yolact.train.copy` span, from its opening
to its closing: the batch copied into pinned memory and its copies to the
device issued, which the device trace does not see."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.host_ms(trace, program_spans.TRAIN_COPY, ctx)
