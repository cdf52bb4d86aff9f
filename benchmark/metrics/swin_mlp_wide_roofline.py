"""Kernel 4's share of its roofline at C = 1536 (Swin-L's stage 3), where
its bf16 form is three launches (LayerNorm, fc1, fc2): each block's bound at
its stage's rows and width, one a LayerNorm launch, over the device time of
all three."""
from benchmark.core import readers
from benchmark.roofline import kernels, peaks


def read(trace, ctx):
    if not ctx.get('stages'):
        return None
    events, places = readers.by_stage_block(trace, r'mlp_wide_(ln|gemm)_kernel')
    bounds = [peaks.bound_s(*kernels.swin_mlp(ctx['stages'][stage]['rows'],
                                              ctx['stages'][stage]['c']))
              for e, (stage, _) in zip(events, places) if 'mlp_wide_ln_kernel' in e.name]
    return readers.roofline_percent(bounds, events)
