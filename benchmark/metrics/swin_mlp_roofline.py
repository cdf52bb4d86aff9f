"""Kernel 4's share of its roofline: each launch's bound at its stage's
rows and width summed, over their device time."""
from benchmark.core import readers
from benchmark.roofline import kernels, peaks


def read(trace, ctx):
    if not ctx.get('stages'):
        return None
    events, places = readers.by_stage_block(trace, r'mlp_bf16_sm90_kernel|mlp_f32_kernel')
    bounds = [peaks.bound_s(*kernels.swin_mlp(ctx['stages'][stage]['rows'],
                                              ctx['stages'][stage]['c']))
              for stage, _ in places]
    return readers.roofline_percent(bounds, events)
