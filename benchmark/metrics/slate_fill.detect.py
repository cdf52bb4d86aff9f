"""The share of the slate's slots (`max_detections` an image) that hold a
detection, by the program's `detect.valid` counter."""
from benchmark.core import program_spans


def read(trace, ctx):
    n = program_spans.counted('detect.valid')
    return None if n is None else 100.0 * n / (ctx['calls'] * ctx['batch'] * ctx['slots'])
