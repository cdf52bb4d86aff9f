"""Device ms a call of the kernels launched in the program's
`yolact.detect.masks` span: the mask finalize kernel and what it stages."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.launched_ms(trace, program_spans.DETECT_MASKS, ctx)
