"""Section timer with device fencing.

Named sections keep a rolling window of their last times; `start()` gates
out the warm-up iterations, and 'data' is derived as batch time minus the
sum of the inner sections. The card's queue is asynchronous, so a section
that must include device work passes a fence, such as
`torch.cuda.synchronize`, called before the clock is read.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

_times: Dict[str, List[float]] = {'batch': [], 'data': []}
_mark = False
_max_len = 100


def reset(length: int = 100):
    global _times, _mark, _max_len
    _times = {'batch': [], 'data': []}
    _mark = False
    _max_len = length


def start():
    global _mark
    _mark = True


def add_batch_time(batch_time: float):
    if not _mark:
        return
    _times['batch'].append(batch_time)
    inner = sum(v[-1] for k, v in _times.items()
                if k not in ('batch', 'data') and v)
    _times['data'].append(batch_time - inner)


def get_times(names) -> List[float]:
    return [float(np.mean(_times[n])) if _times.get(n) else 0.0 for n in names]


class counter:
    """Context manager timing one named section. `fence`, when given, is
    called before the clock is read at the end (torch.cuda.synchronize on
    the card)."""

    def __init__(self, name: str, fence: Optional[Callable[[], object]] = None):
        self.name = name
        self.fence = fence
        for v in _times.values():
            if len(v) >= _max_len:
                v.pop(0)

    def __enter__(self):
        if _mark:
            _times.setdefault(self.name, [])
            _times[self.name].append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        if _mark:
            if self.fence is not None:
                self.fence()
            _times[self.name][-1] = time.perf_counter() - _times[self.name][-1]
