"""The timed window, the traced slice and the spans the benchmark opens.

A session (an entry's `setup`) offers `call(i)`, one unit of the cell's
work. The window calls it in a closed loop from i = 0 until `seconds` have
passed, then waits for the device: every call's host time is kept (its
latency where the call itself waits for its result). A traced run then
profiles `trace_calls` more calls, with the benchmark's spans opened around
each call and by forward hooks around the modules the session names, and
reads the events in memory."""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import torch


class Marks:
    """Seconds of each named phase of a set-up, for its standard error."""

    def __init__(self):
        self.last, self.phases = time.perf_counter(), []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.phases.append((name, now - self.last))
        self.last = now

    def line(self) -> str:
        return 'set-up: ' + ', '.join(f'{n} {s:.3f} s' for n, s in self.phases)


def sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(session, seconds: float) -> Tuple[List[float], float]:
    """(host seconds of every call, the window's seconds)."""
    lat = []
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        session.call(i)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        i += 1
        if t1 - t_start >= seconds:
            break
    sync(session.device)
    return lat, time.perf_counter() - t_start


class _SpanHooks:
    """A record_function span around each forward of the named modules."""

    def __init__(self, modules: Sequence[Tuple[torch.nn.Module, str]]):
        self.handles = []
        for module, name in modules:
            stack = []

            def pre(_mod, _args, name=name, stack=stack):
                rf = torch.profiler.record_function(name)
                rf.__enter__()
                stack.append(rf)

            def post(_mod, _args, _out, stack=stack):
                stack.pop().__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(pre),
                             module.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()


def traced_slice(session, first: int, calls: int):
    """Profile `calls` calls from index `first`: returns the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if session.device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    hooks = _SpanHooks(session.span_modules())
    sync(session.device)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function('bench.slice'):
                for i in range(first, first + calls):
                    with torch.profiler.record_function('bench.call'):
                        session.call(i)
                sync(session.device)
    finally:
        hooks.remove()
    return prof
