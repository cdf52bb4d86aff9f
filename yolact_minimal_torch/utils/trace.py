"""Profiler spans and work counters at the port's layer boundaries.

`span(name)` is a `torch.profiler.record_function` range while a profiler
records, so that the port's layers land in the same trace as the device's
activity and on its clock; otherwise it is a shared no-op context, since a
range costs host time (~15 us) even with no profiler to read it. Names are
`yolact.<path>.<layer>`.

`count(name, value)` keeps a reference to a tensor the call computes
anyway (a mask, a count), or a host integer (a size), and only while a
profiler records: it launches nothing and waits for nothing. A value that
costs host work to compute may be given as a function of no arguments,
called only then. `counts()`
sums what was kept, by name, synchronising then; `reset()` forgets it. A
kept tensor must not be written in place afterwards.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Union

import torch

_OFF = contextlib.nullcontext()
_kept: Dict[str, List[Union[torch.Tensor, int]]] = {}


def _recording() -> bool:
    return torch.autograd._profiler_enabled()


def span(name: str):
    return torch.profiler.record_function(name) if _recording() else _OFF


def count(name: str, value: Union[torch.Tensor, int, Callable[[], int]]) -> None:
    if _recording():
        _kept.setdefault(name, []).append(value() if callable(value) else value)


def counts() -> Dict[str, int]:
    """The sum of every value kept under each name, as host integers."""
    with torch.no_grad():
        return {name: sum(int(t.sum()) if torch.is_tensor(t) else int(t) for t in kept)
                for name, kept in _kept.items()}


def reset() -> None:
    _kept.clear()
