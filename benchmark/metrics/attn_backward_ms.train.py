"""Device ms a step of kernel 3's backward: the kernels launched inside the
autograd engine's ranges of `yolact_torch::window_attention`'s node
(`GeneratedBackwardFor_yolact_torch_window_attention_defaultBackward`),
whatever the backward launches there. None where the slice holds none."""
from benchmark.core import readers

NODE = 'yolact_torch_window_attention'


def read(trace, ctx):
    events = readers.in_spans(trace, lambda n: n.startswith(readers.BACKWARD) and NODE in n)
    return readers.per_call_ms(trace, events, ctx) if events else None
