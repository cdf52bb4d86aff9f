"""Kernel 2's share of its roofline: the sum of its launches' bounds (each
at the call's batch, slots and sizes) over their device time."""
from benchmark.core import readers
from benchmark.roofline import kernels, peaks


def read(trace, ctx):
    events = trace.kernels(r'mask_finalize_kernel')
    side = ctx['img_size'] // 4
    one = peaks.bound_s(*kernels.mask_finalize(ctx['batch'], ctx['slots'], side, side, 32,
                                               ctx['img_size']), peaks.FLOAT32_FLOPS)
    return readers.roofline_percent([one] * len(events), events)
