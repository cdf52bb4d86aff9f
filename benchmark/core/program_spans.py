"""The program's own spans and counters, as the per-layer metrics read them.

The port opens `yolact.*` profiler ranges at its layer boundaries and keeps
work counters while a profiler records (`yolact_minimal_torch/utils/
trace.py`). Here a moment of the calling thread (the thread of `bench.call`)
belongs to the innermost program span open on it then, so a span's share
leaves out its child program spans:

  * a device event belongs to the span that holds its launch on the
    calling thread;
  * an idle gap of the device (`Trace.idle_gaps`) is split among the spans
    that hold its parts on the calling thread: what the program was doing
    while the device waited.

A program without these spans or counters gives None.
"""
from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Set, Tuple

from benchmark.core import readers
from benchmark.core.trace import Event, Spans, Trace

PREFIX = 'yolact.'
DETECT_COPY = 'yolact.detect.copy'
DETECT_FORWARD = 'yolact.detect.forward'
DETECT_NMS = 'yolact.detect.nms'
DETECT_MASKS = 'yolact.detect.masks'
TRAIN_COPY = 'yolact.train.copy'
TRAIN_MATCH = 'yolact.train.match'
TRAIN_LOSS = 'yolact.train.loss'
SWIN_GLUE = 'yolact.swin.glue'


def _program(trace: Trace) -> Spans:
    return trace.spans(lambda n: n.startswith(PREFIX))


def _calling_threads(trace: Trace) -> Set[int]:
    return {e.tid for e in trace.named(readers.CALL)}


def launched(trace: Trace, name: str) -> Optional[List[Event]]:
    """The kernels whose launch `name` holds as the innermost program span
    on the calling thread; None where the slice holds no such span."""
    if not trace.named(name):
        return None
    spans, tids = _program(trace), _calling_threads(trace)
    out = []
    for e in trace.kernels():
        where = trace.launch.get(id(e))
        if where is None or where[1] not in tids:
            continue
        held = spans.holding(*where)
        if held is not None and held.name == name:
            out.append(e)
    return out


def launched_ms(trace: Trace, name: str, ctx: dict) -> Optional[float]:
    """Device ms a call of the kernels `launched` in `name`."""
    events = launched(trace, name)
    return None if events is None else readers.per_call_ms(trace, events, ctx)


def _idle_before(gaps: List[Tuple[float, float]]) -> Callable[[float], float]:
    """t -> the idle time of `gaps` (sorted, disjoint) before t."""
    starts = [s for s, _ in gaps]
    before = [0.0]
    for s, t in gaps:
        before.append(before[-1] + t - s)

    def at(t: float) -> float:
        i = bisect.bisect_right(starts, t) - 1
        return 0.0 if i < 0 else before[i] + min(t, gaps[i][1]) - gaps[i][0]
    return at


def idle_ms(trace: Trace, name: str, ctx: dict) -> Optional[float]:
    """Device-idle ms a call while `name` was the innermost program span on
    the calling thread; None where the slice holds no such span."""
    if not trace.named(name):
        return None
    spans = _program(trace)
    idle = _idle_before(trace.idle_gaps())
    total = 0.0
    for tid in _calling_threads(trace):
        own = spans.by_tid.get(tid, ((), ()))[1]
        edges = sorted({t for e in own for t in (e.start, e.end)})
        for a, b in zip(edges, edges[1:]):
            held = spans.holding((a + b) / 2, tid)
            if held is not None and held.name == name:
                total += idle(b) - idle(a)
    return total / 1e3 / ctx['calls']


def host_ms(trace: Trace, name: str, ctx: dict) -> Optional[float]:
    """Host ms a call of the spans `name` on the calling thread, from their
    opening to their closing."""
    tids = _calling_threads(trace)
    spans = [e for e in trace.named(name) if e.tid in tids]
    return readers.ms(spans) / ctx['calls'] if spans else None


def counted(name: str) -> Optional[int]:
    """The program's counter `name` over what the profiler recorded; None
    where the program keeps no such counter."""
    try:
        from yolact_minimal_torch.utils import trace as program_trace
    except ImportError:
        return None
    return program_trace.counts().get(name)
