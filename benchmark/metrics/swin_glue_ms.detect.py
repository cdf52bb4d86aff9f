"""Device ms a call of the kernels launched in the program's `yolact.swin.glue`
spans: each block's pad, roll and window partition, and their reverse."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.launched_ms(trace, program_spans.SWIN_GLUE, ctx)
