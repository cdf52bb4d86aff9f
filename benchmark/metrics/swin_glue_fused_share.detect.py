"""The share of the swin attention halves whose glue runs as the two
hand-written glue kernels (norm1 into the windows, the windows back onto the
residual), by the program's counters `swin.attn_blocks` (every attention
half) and `swin.glue_fused_blocks` (the halves routed to the kernels); 0
where a program counts the halves and routes none."""
from benchmark.core import program_spans


def read(trace, ctx):
    blocks = program_spans.counted('swin.attn_blocks')
    if not blocks:
        return None
    return 100.0 * (program_spans.counted('swin.glue_fused_blocks') or 0) / blocks
