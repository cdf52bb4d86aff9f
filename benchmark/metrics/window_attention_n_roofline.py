"""Kernel 3's share of its roofline at any window: each launch's bound at
its stage's shapes and N = window * window tokens (its block shifted or
not) summed, over their device time."""
from benchmark.core import readers
from benchmark.roofline import peaks, windows


def read(trace, ctx):
    if not ctx.get('stages'):
        return None
    events, places = readers.by_stage_block(trace, r'window_attention_(n\d+_)?(bf16|f32)_kernel')
    bounds = []
    for stage, block in places:
        s = ctx['stages'][stage]
        bounds.append(peaks.bound_s(*windows.window_attention(
            s['windows'], s['n_win'], s['heads'], s['c'], block % 2 == 1,
            windows.stage_tokens(s))))
    return readers.roofline_percent(bounds, events)
