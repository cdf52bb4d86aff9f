"""A run of one cell: set-up, the window, the traced slice, the comparison
and the result line."""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from benchmark.core import cell as cells
from benchmark.core import guard, judge, trace as traces, window


def _device_info(device: torch.device, trace_result: Optional[traces.Trace]) -> dict:
    if device.type == 'cuda':
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': 1,
                'memory_peak_bytes': int(torch.cuda.max_memory_allocated(device))}
    else:
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    if trace_result is not None:
        info.update(busy_s=trace_result.busy_s, window_s=trace_result.window_s)
    return info


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, started: Tuple[float, float]) -> Tuple[dict, List[str]]:
    """started: (perf_counter, seconds since the process started) read
    together at the process's start. Returns (the result, the lines of the
    comparison for standard error). Any whole seed is taken, modulo 2**62."""
    seed %= 2 ** 62
    before = started[1] + (time.perf_counter() - started[0])
    session = cell.entry.setup(cell, seed, device)
    setup_s = started[1] + (time.perf_counter() - started[0])
    lat, window_s = window.run(session, seconds)
    traced = None
    if trace:
        prof = window.traced_slice(session, len(lat), cell.traffic['trace_calls'])
        traced = traces.Trace(traces.from_profiler(prof))
        del prof
    info = _device_info(device, traced)
    metrics = {}
    if trace:
        ctx = dict(session.reader_context(cell.traffic['trace_calls'], len(lat), window_s),
                   window_latencies_s=lat)
        for m in cell.per_layer:
            value = cells.metric_reader(m['name']).read(traced, ctx)
            if value is not None:
                metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    else:
        e2e = dict(session.end_to_end(lat, window_s), setup_s=setup_s)
        metrics = {m['name']: {'value': float(e2e[m['name']]), 'unit': m['unit']}
                   for m in cell.end_to_end}
    session.release()
    found = guard.forbidden_loaded()
    if found:
        raise SystemExit(f'modules that the benchmark must not load were loaded: {found}')
    results = judge.checks(session.judge(), cell.limits['checks'])
    result = {'correct': all(c.ok for c in results), 'attempted': len(lat), 'failed': 0,
              'metrics': metrics, 'device': info}
    if traced is not None:
        result['breakdown'] = traced.breakdown()
    result['checks'] = {c.name: {'value': c.value, 'limit': c.limit} for c in results}
    lines = [f'process start to the harness {before:.3f} s; ' + session.marks.line()]
    lines += [f'check {c.name}: {c.value!r} limit {c.limit!r} {"ok" if c.ok else "FAILED"}'
             for c in results]
    return result, lines
