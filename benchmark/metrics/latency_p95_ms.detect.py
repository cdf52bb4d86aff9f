"""The 95th percentile of the latency of every call of the run's untraced
window, from its issue until its slate and masks are ready behind a
synchronize: how late a detection can be. A per-layer reading, without a
bound: from run to run it swings with the host (PERF.md)."""
import numpy as np


def read(trace, ctx):
    return float(np.percentile(np.asarray(ctx['window_latencies_s']) * 1e3, 95))
