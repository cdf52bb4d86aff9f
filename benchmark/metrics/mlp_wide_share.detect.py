"""The share of kernel 4's calls that run as its wide form (LayerNorm, fc1
and fc2 as three launches), by the program's counters `swin.mlp_blocks`
(every call) and `swin.mlp_wide_blocks` (the calls routed to the wide
form)."""
from benchmark.core import program_spans


def read(trace, ctx):
    blocks, wide = program_spans.counted('swin.mlp_blocks'), program_spans.counted(
        'swin.mlp_wide_blocks')
    if not blocks or wide is None:
        return None
    return 100.0 * wide / blocks
