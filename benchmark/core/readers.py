"""What the per-layer metric files share: device time a call of the
kernels some spans launched, the idle share, a kernel's share of its
roofline, and the launches of a kernel by swin stage and block."""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from benchmark.core.trace import Event, Trace
from benchmark.roofline import peaks

FORWARD = 'bench.forward'
BACKBONE = 'bench.backbone'
CALL = 'bench.call'
BACKWARD = 'autograd::engine::evaluate_function'
OPTIMIZER = 'Optimizer.step#'


def ms(events: List[Event]) -> float:
    return sum(e.end - e.start for e in events) / 1e3


def per_call_ms(trace: Trace, events: List[Event], ctx: dict) -> float:
    return ms(events) / ctx['calls']


def in_spans(trace: Trace, match: Callable[[str], bool], kernels=None) -> List[Event]:
    kernels = trace.kernels() if kernels is None else kernels
    return trace.launched_in(kernels, trace.spans(match))


def h2d_copies(trace: Trace) -> List[Event]:
    return [e for e in trace.device if e.kind == 'memcpy' and 'HtoD' in e.name]


def idle_percent(trace: Trace) -> float:
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu_percent(ctx: dict) -> float:
    """Over the run's untraced window: the profiler slows the host."""
    return 100.0 * ctx['flops_per_call'] * ctx['window_calls'] / ctx['window_s'] \
        / peaks.BF16_FLOPS


def roofline_percent(bounds_s: List[float], events: List[Event]) -> Optional[float]:
    """The sum of the launches' bounds over the sum of their device time;
    None where the slice holds no launch."""
    if not events:
        return None
    return 100.0 * sum(bounds_s) / (ms(events) / 1e3)


def by_stage_block(trace: Trace, pattern: str) -> Tuple[List[Event], List[Tuple[int, int]]]:
    """The launches of `pattern` inside the `bench.stage<i>` spans, each with
    (stage, block): the block is the launch's place among the launches of
    its stage's span."""
    spans = trace.spans(lambda n: n.startswith('bench.stage'))
    groups: Dict[int, List[Tuple[float, Event, int]]] = defaultdict(list)
    for e in trace.kernels(pattern):
        where = trace.launch.get(id(e))
        held = spans.holding(*where) if where else None
        if held is not None:
            groups[id(held)].append((where[0], e, int(held.name[len('bench.stage'):])))
    events, places = [], []
    for launches in groups.values():
        for block, (_, e, stage) in enumerate(sorted(launches, key=lambda x: x[0])):
            events.append(e)
            places.append((stage, block))
    return events, places
