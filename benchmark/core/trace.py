"""The trace reader shared by the per-layer metrics.

A traced slice is a list of `Event`s, read in memory from the profiler
(`from_profiler`) or written by hand in tests:

  * 'op': a host range: an operator, a span the benchmark opened
    (`bench.*`), PyTorch's own annotations (`Optimizer.step#...`,
    `autograd::engine::evaluate_function: ...`);
  * 'runtime': a CUDA runtime or driver call on the host (a launch, a copy);
  * 'kernel', 'memcpy', 'memset': device intervals.

The profiler also mirrors each host annotation (a `record_function` range,
`Optimizer.step#...`) onto the device's timeline; those mirrors are left
out, as they are not device work.

A device event is attributed to host spans through its launch: the runtime
call with the same correlation id gives the host time and thread of the
launch (or, failing that, the operator the profiler linked it to), and a
span holds the launch when it is open on that thread at that time.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_KINDS = ('kernel', 'memcpy', 'memset')

# Kernel groups of a profile, first match wins, on the CUDA kernel names the
# profiler reports (the groups of chip_smoke.py's phase 5).
GROUPS = (
    ('suppression kernel', r'suppression_kernel'),
    ('mask_finalize kernel', r'mask_finalize_kernel'),
    ('window_attention kernel', r'window_attention_(bf16|f32)_kernel'),
    ('swin_mlp kernel', r'mlp_bf16_sm90_kernel|mlp_f32_kernel'),
    ('attn_block kernel', r'attn_block_\w*kernel|attn_heads_\w*kernel|proj_rows_\w*kernel'),
    ('swin_block kernel', r'swin_block_\w*kernel'),
    ('layer norm', r'layer_norm|LayerNorm'),
    ('convolution / gemm', r'conv|gemm|xmma|cutlass|cudnn|sm90_|implicit|nvjet|cublas'),
    ('copy / cast / roll / pad', r'copy_kernel|roll_cuda|constant_pad|CatArray'),
    ('sort / top-k', r'sort|radix|topk|Sort'),
    ('batch norm', r'batch_norm|bn_'),
    ('gather / index', r'index|gather|scatter'),
    ('elementwise / reduce', r'elementwise|reduce|vectorized|unrolled'),
)

_RUNTIME = re.compile(r'^(cuda|cu)[A-Z]')


@dataclass
class Event:
    name: str
    kind: str
    start: float          # microseconds
    end: float
    tid: int = 0
    corr: int = 0         # correlation id (device event <-> runtime call)
    link: int = 0         # the operator the profiler linked a device event to


def group_of(name: str) -> str:
    return next((g for g, pat in GROUPS if re.search(pat, name)), 'other')


def _kind(name: str, on_device: bool) -> str:
    if on_device:
        if name.startswith('Memcpy'):
            return 'memcpy'
        if name.startswith('Memset'):
            return 'memset'
        return 'kernel'
    return 'runtime' if _RUNTIME.match(name) else 'op'


def from_profiler(prof) -> List[Event]:
    """The events of a finished torch.profiler.profile, without building
    its function-event tree; device mirrors of host annotations left out."""
    import torch
    raw = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name() for e in raw if e.device_type() == cpu}
    out = []
    for e in raw:
        on_device = e.device_type() != cpu
        kind = getattr(e, 'activity_type', lambda: '')()
        if on_device and (e.name() in host_names or 'annotation' in str(kind)):
            continue
        if hasattr(e, 'start_ns'):
            start = e.start_ns() / 1e3
            end = (e.end_ns() if hasattr(e, 'end_ns') else e.start_ns() + e.duration_ns()) / 1e3
        else:
            start, end = e.start_us(), e.start_us() + e.duration_us()
        out.append(Event(e.name(), _kind(e.name(), on_device), float(start), float(end),
                         int(e.start_thread_id()), int(e.correlation_id()),
                         int(e.linked_correlation_id())))
    return out


class Spans:
    """The host ranges of one name (or name predicate), by thread, for
    lookups of which ones hold a time."""

    def __init__(self, events: Iterable[Event]):
        self.by_tid: Dict[int, Tuple[List[float], List[Event]]] = {}
        for e in sorted(events, key=lambda e: e.start):
            starts, evs = self.by_tid.setdefault(e.tid, ([], []))
            starts.append(e.start)
            evs.append(e)

    def holding(self, t: float, tid: int) -> Optional[Event]:
        """The innermost range open at t on thread tid, or None."""
        starts, evs = self.by_tid.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 4096, -1), -1):
            if evs[j].end >= t:
                return evs[j]
        return None

    def all(self) -> List[Event]:
        return sorted((e for v in self.by_tid.values() for e in v[1]), key=lambda e: e.start)


class Trace:
    """One traced slice: `window` is the benchmark's `bench.slice` span."""

    def __init__(self, events: Sequence[Event], window_name: str = 'bench.slice'):
        self.events = list(events)
        ops = [e for e in self.events if e.kind == 'op']
        windows = [e for e in ops if e.name == window_name]
        if len(windows) != 1:
            raise ValueError(f'expected one {window_name!r} span, found {len(windows)}')
        self.window = windows[0]
        self.ops = ops
        runtime = {e.corr: e for e in self.events if e.kind == 'runtime' and e.corr}
        op_by_corr = {e.corr: e for e in ops if e.corr}
        self.device: List[Event] = []
        self.launch: Dict[int, Tuple[float, int]] = {}
        for e in self.events:
            if e.kind not in DEVICE_KINDS or e.end < self.window.start or e.start > self.window.end:
                continue
            self.device.append(e)
            host = runtime.get(e.corr) or op_by_corr.get(e.link)
            if host is not None:
                self.launch[id(e)] = (host.start, host.tid)

    # --- lookups ---------------------------------------------------------------

    def spans(self, match: Callable[[str], bool]) -> Spans:
        return Spans(e for e in self.ops if match(e.name))

    def named(self, name: str) -> List[Event]:
        return sorted((e for e in self.ops if e.name == name), key=lambda e: e.start)

    def kernels(self, pattern: Optional[str] = None) -> List[Event]:
        ks = [e for e in self.device if e.kind == 'kernel']
        return ks if pattern is None else [e for e in ks if re.search(pattern, e.name)]

    def launched_in(self, events: Iterable[Event], spans: Spans) -> List[Event]:
        """The device events whose launch one of `spans` holds."""
        out = []
        for e in events:
            where = self.launch.get(id(e))
            if where is not None and spans.holding(*where) is not None:
                out.append(e)
        return out

    # --- the device's time ------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals, clipped to the window."""
        lo, hi = self.window.start, self.window.end
        ivs = sorted((max(e.start, lo), min(e.end, hi)) for e in self.device)
        merged: List[List[float]] = []
        for s, t in ivs:
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        edges = [self.window.start]
        for s, t in self.busy_intervals():
            edges += [s, t]
        edges.append(self.window.end)
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def breakdown(self, top: int = 10) -> dict:
        """The device time by kernel group (ungrouped kernels by name) and
        the idle time by what the host was doing (the operator or span
        opened last, on any thread, of those open at the gap's middle: the
        autograd engine's thread dispatches while the caller waits), each
        the `top` largest, in seconds."""
        by_op: Dict[str, float] = {}
        for e in self.device:
            key = e.name[:80] if e.kind != 'kernel' else group_of(e.name)
            if key == 'other':
                key = e.name[:80]
            by_op[key] = by_op.get(key, 0.0) + (e.end - e.start) / 1e6
        host = Spans(e for e in self.ops if e is not self.window)
        by_host: Dict[str, float] = {}
        for s, t in sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:2000]:
            held = [h for h in (host.holding((s + t) / 2, tid) for tid in host.by_tid) if h]
            key = max(held, key=lambda h: h.start).name[:80] if held else 'host between calls'
            by_host[key] = by_host.get(key, 0.0) + (t - s) / 1e6
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {'device_ops': pick(by_op), 'idle_gaps': pick(by_host)}
