"""Device ms a step of the kernels launched in the program's
`yolact.train.match` span: the anchors matched to the ground truth."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.launched_ms(trace, program_spans.TRAIN_MATCH, ctx)
