"""Device ms a call of the kernels launched in the program's `yolact.detect.nms`
span: decode, threshold, the pre-top-k and per-class top-k, the suppression
kernel and the selection of the slate."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.launched_ms(trace, program_spans.DETECT_NMS, ctx)
