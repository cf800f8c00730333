"""The traced run: benchmark spans (host clock, and the profiler's own
ranges for the device timeline) and the reduction of a torch.profiler
trace to device busy time, time by device operation, idle gaps by the
span that was open, and time by kernel.

An interval is (name, start, end) in seconds of one clock; the profiler's
events are read in microseconds and turned into seconds here."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

Interval = Tuple[str, float, float]
SPAN_PREFIX = "portbench:"
WINDOW = "window"


class Spans:
    """Host-clock spans by name, each also a torch.profiler range, so the
    trace places it beside the device's work. Off (the untraced run), a
    span is a no-op."""

    def __init__(self, on: bool = False):
        self.on = on
        self.times: Dict[str, List[float]] = defaultdict(list)
        self._wrapped: List[tuple] = []

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.on:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            try:
                yield
            finally:
                self.times[name].append(time.perf_counter() - t0)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Put a span around every call of owner.attr (a class's method
        or a module's function)."""
        fn = getattr(owner, attr)
        spans = self

        def call(*args, **kwargs):
            with spans.span(name):
                return fn(*args, **kwargs)

        self._wrapped.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, call)

    def unwrap(self) -> None:
        """Take away every span wrap() put in."""
        for owner, attr, orig in reversed(self._wrapped):
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        self._wrapped = []

    def iterate(self, it, name: str):
        """Yield from `it` with a span around each next()."""
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def total(self, name: str) -> Optional[float]:
        t = self.times.get(name)
        return sum(t) if t else None


def profiler_events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, benchmark spans) of a finished torch.profiler
    profile, in seconds from the trace's start. Reads the profiler's raw
    events: building its event tree takes minutes for a window of
    hundreds of thousands of launches."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results
    t0 = raw.trace_start_ns()
    device, spans = [], []
    for e in raw.events():
        name = e.name()
        a = (e.start_ns() - t0) * 1e-9
        b = a + e.duration_ns() * 1e-9
        if name.startswith(SPAN_PREFIX):
            # a span's range; on the device timeline it is an annotation
            # of the profiler's, not work
            if e.device_type() != DeviceType.CUDA:
                spans.append((name[len(SPAN_PREFIX):], a, b))
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, a, b))
    return device, spans


def union(intervals: List[Interval], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of the intervals, clipped to [lo, hi], as sorted
    disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(device: List[Interval], lo: float, hi: float) -> float:
    return sum(b - a for a, b in union(device, lo, hi))


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    name = name.strip()
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].strip() or name
    return name


def by_name(device: List[Interval], lo: float, hi: float,
            top: int = 10) -> List[List]:
    """[[operation, seconds]] of the operations that took most device time
    inside [lo, hi], most first."""
    tot: Dict[str, float] = defaultdict(float)
    for name, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            tot[short_name(name)] += b - a
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])][:top]


def idle_by_span(device: List[Interval], spans: List[Interval], lo: float,
                 hi: float, top: int = 10) -> List[List]:
    """[[span, seconds]]: the device's idle time inside [lo, hi], each gap
    given to the innermost benchmark span open at its middle (the open
    span that started last; "none" where none is), most first."""
    gaps, t = [], lo
    for a, b in union(device, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    todo = sorted((s for s in spans if s[0] != WINDOW), key=lambda s: s[1])
    tot: Dict[str, float] = defaultdict(float)
    active: List[Interval] = []
    k = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(todo) and todo[k][1] <= mid:
            active.append(todo[k])
            k += 1
        active = [s for s in active if s[2] >= mid]
        tot[active[-1][0] if active else "none"] += b - a
    return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])][:top]


def kernel_time(device: List[Interval], part: str, lo: float, hi: float
                ) -> Tuple[float, int]:
    """(seconds, count) of the device operations whose name holds `part`,
    inside [lo, hi]."""
    s, n = 0.0, 0
    for name, a, b in device:
        if part in name and a >= lo and b <= hi:
            s += b - a
            n += 1
    return s, n


def span_per_unit(run, span: str) -> Optional[float]:
    """Milliseconds of a benchmark span per unit of work in the window."""
    total = run.spans.total(span)
    if total is None or run.units == 0:
        return None
    return total * 1e3 / run.units


def kernel_count(device: List[Interval], lo: float, hi: float) -> int:
    """Kernels inside [lo, hi]: device operations other than copies and
    fills."""
    return sum(1 for name, a, b in device
               if a >= lo and b <= hi
               and not name.startswith(("Memcpy", "Memset")))
