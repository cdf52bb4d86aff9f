"""Kernel 3's share of its roofline: each launch's bound at its stage's
shapes (its block shifted or not) summed, over their device time."""
from benchmark.core import readers
from benchmark.roofline import kernels, peaks


def read(trace, ctx):
    if not ctx.get('stages'):
        return None
    events, places = readers.by_stage_block(trace, r'window_attention_(bf16|f32)_kernel')
    bounds = []
    for stage, block in places:
        s = ctx['stages'][stage]
        bounds.append(peaks.bound_s(*kernels.window_attention(
            s['windows'], s['n_win'], s['heads'], s['c'], block % 2 == 1)))
    return readers.roofline_percent(bounds, events)
