"""Anchors matched as positives an image, by the program's `train.positives`
counter: the work of the box and mask losses."""
from benchmark.core import program_spans


def read(trace, ctx):
    n = program_spans.counted('train.positives')
    return None if n is None else n / (ctx['calls'] * ctx['batch'])
