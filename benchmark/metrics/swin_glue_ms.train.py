"""Device ms a step of the kernels launched in the program's `yolact.swin.glue`
spans on the calling thread: the forward's glue. The backward's runs on the
autograd engine's thread, under PyTorch's own names."""
from benchmark.core import program_spans


def read(trace, ctx):
    return program_spans.launched_ms(trace, program_spans.SWIN_GLUE, ctx)
