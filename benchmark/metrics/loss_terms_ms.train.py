"""Device ms a step of the kernels launched in the program's
`yolact.train.loss` span outside the matcher's: the four losses."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.launched_ms(trace, program_spans.TRAIN_LOSS, ctx)
