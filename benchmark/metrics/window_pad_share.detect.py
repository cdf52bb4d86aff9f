"""The share of the rows the attention halves run on that is padding, by
the program's counters `swin.rows` (the rows each half is given) and
`swin.window_rows` (the rows of its windows, padding included)."""
from benchmark.core import program_spans


def read(trace, ctx):
    rows, padded = program_spans.counted('swin.rows'), program_spans.counted('swin.window_rows')
    if rows is None or not padded:
        return None
    return 100.0 * (padded - rows) / padded
