"""Anchors an image that reach fast NMS, by the program's `nms.candidates`
counter (those of the pre-top-k over the score threshold): the pre-top-k
cap, 1024, where it binds."""
from benchmark.core import program_spans


def read(trace, ctx):
    n = program_spans.counted('nms.candidates')
    return None if n is None else n / (ctx['calls'] * ctx['batch'])
