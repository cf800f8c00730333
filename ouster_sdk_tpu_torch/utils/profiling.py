"""Profiling: the program's tracer, wall/cpu stage timers and device traces.

The reference ships benchmark harnesses but no tracer (ref: SURVEY.md §5.1).
This module adds three things.

The tracer. `span(name)` times a layer of the program and `count(name, n)`
counts work where it happens; both record into a bounded buffer in the
program's own memory that `snapshot()` reads and `clear()` empties. A span
records its name, its start and end in `time.time_ns()` (the clock
torch.profiler stamps its events with, so spans and the device trace share
one timeline), its thread, the span open on that thread when it began (its
parent), the thread's CPU time over the span and, where it belongs to one
chunk or scan, a key (the first frame id). A span is never a profiler range:
a range that encloses launches shows up on the device timeline too, and
would be read as device work.

When it records: where an operator switched it with `tracing(True)` or
`tracing(False)`; otherwise on any thread where torch.profiler is
recording (the profiler's flag is per thread: a thread the program starts
takes the starting thread's state with `carry()`). Off, a span costs a check
of the switch and of the profiler's flag and records nothing.

`ProfileRunner` accumulates wall and CPU time per named stage, timed as a
span is (and recorded as one when tracing is on), in the report-JSON shape
of `ouster-cli util benchmark` (ref: cli/core/util.py:180-310).
`device_trace()` writes a torch.profiler Chrome trace (CPU and, where there
is one, the CUDA device) with the program's spans of its window in it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import platform
import tempfile
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

from torch.autograd import _profiler_enabled

#: Spans, and counts, the buffer keeps; older ones are dropped and counted.
LIMIT = 1 << 18


class SpanRecord(NamedTuple):
    """A finished span. Times are `time.time_ns()`; `thread` is the native
    thread id; `parent` is the id of the span open on the same thread when
    this one began (0: none)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int
    cpu_ns: int
    key: Optional[int]
    id: int


class CountRecord(NamedTuple):
    """`n` added to the counter `name` at `time_ns` on `thread`."""

    name: str
    time_ns: int
    n: int
    thread: int


@dataclass
class Snapshot:
    """What the tracer holds: spans and counts since the last clear(), the
    clock pair (time.time_ns(), time.perf_counter_ns()) read together when
    the snapshot was taken, and how many records the bound dropped."""

    spans: List[SpanRecord]
    counts: List[CountRecord]
    clock: Tuple[int, int]
    dropped: int


class _Null:
    """The span of a tracer that is off: records nothing."""

    __slots__ = ()
    key = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setattr__(self, name, value) -> None:
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("tracer", "name", "key", "record", "id", "parent", "t0",
                 "c0", "wall_ns", "cpu_ns")

    def __init__(self, tracer: "Tracer", name: str, key: Optional[int],
                 record: bool):
        self.tracer, self.name, self.key, self.record = \
            tracer, name, key, record

    def __enter__(self) -> "_Span":
        stack = self.tracer._local.stack
        self.parent = stack[-1].id if stack else 0
        self.id = next(self.tracer._ids)
        stack.append(self)
        self.c0 = time.thread_time_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        self.cpu_ns = time.thread_time_ns() - self.c0
        self.wall_ns = t1 - self.t0
        self.tracer._local.stack.pop()
        if self.record:
            self.tracer._append(self.tracer._spans, SpanRecord(
                self.name, self.t0, t1, self.tracer._local.thread,
                self.parent, self.cpu_ns, self.key, self.id))
        return False


class _Switch:
    """Sets a tracer's mode at once; as a context manager, restores the
    mode it found on exit."""

    def __init__(self, tracer: "Tracer", on: Optional[bool]):
        self.tracer, self.before = tracer, tracer.mode
        tracer.mode = on

    def __enter__(self) -> "_Switch":
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer.mode = self.before
        return False


class _Carry:
    """The state of the thread that made it, for the body of a thread that
    thread starts."""

    def __init__(self, tracer: "Tracer", on: bool):
        self.tracer, self.on = tracer, on

    def __enter__(self) -> "_Carry":
        self.tracer._local.carried = self.on
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer._local.carried = False
        return False


class _Local(threading.local):
    """A thread's open spans, its native id (read once: a system call)
    and whether it runs with a carried state."""

    carried = False

    def __init__(self):
        self.stack: list = []
        self.thread = threading.get_native_id()


class Tracer:
    """Spans and counts in a bounded buffer (see the module's docstring).
    The module's functions use one tracer of the process."""

    def __init__(self, limit: int = LIMIT):
        #: the operator's switch: True on, False off, None: follow the
        #: profiler
        self.mode: Optional[bool] = None
        self._spans: collections.deque = collections.deque(maxlen=limit)
        self._counts: collections.deque = collections.deque(maxlen=limit)
        self._lock = threading.Lock()
        self._dropped = 0
        self._local = _Local()
        self._ids = itertools.count(1)

    def on(self) -> bool:
        """Whether this thread records now."""
        mode = self.mode
        if mode is not None:
            return mode
        return _profiler_enabled() or self._local.carried

    def _append(self, buf: collections.deque, rec) -> None:
        with self._lock:
            if len(buf) == buf.maxlen:
                self._dropped += 1
            buf.append(rec)

    def span(self, name: str, key: Optional[int] = None):
        """A context manager that records a span `name` when tracing is on;
        `key` (or `.key` set on what it yields) marks the chunk or scan it
        belongs to. Inside a span of the same name it records nothing (the
        outer one holds the time)."""
        if not self.on():
            return _NULL
        stack = self._local.stack
        if stack and stack[-1].name == name:
            return _NULL
        return _Span(self, name, key, True)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name`, with the time, when tracing is
        on."""
        if self.on():
            self._append(self._counts, CountRecord(
                name, time.time_ns(), n, self._local.thread))

    def tracing(self, on: Optional[bool]) -> _Switch:
        """The operator's switch: True records on every thread, False on
        none, None follows the profiler. Takes effect at once; used as a
        context manager, the switch goes back on exit."""
        return _Switch(self, on)

    def carry(self) -> _Carry:
        """Called on a thread that starts another: a context manager for
        the new thread's body that gives it this thread's state."""
        return _Carry(self, self.on())

    def snapshot(self) -> Snapshot:
        with self._lock:
            spans, counts = list(self._spans), list(self._counts)
            dropped = self._dropped
        return Snapshot(spans, counts,
                        (time.time_ns(), time.perf_counter_ns()), dropped)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()
            self._dropped = 0


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
tracing = _TRACER.tracing
carry = _TRACER.carry
snapshot = _TRACER.snapshot
clear = _TRACER.clear


@dataclass
class ProfileRunner:
    """Accumulates wall/cpu time per named stage
    (ref: python/tests/test_performance.py:21-51 ProfileRunner). A stage is
    timed as a span is: the CPU time is its thread's."""

    records: Dict[str, List[float]] = dc_field(default_factory=dict)

    @contextlib.contextmanager
    def run(self, name: str) -> Iterator[None]:
        s = _Span(_TRACER, name, None, _TRACER.on())
        try:
            with s:
                yield
        finally:
            self.records.setdefault(name, []).append(s.wall_ns * 1e-9)
            self.records.setdefault(name + "_cpu", []).append(
                s.cpu_ns * 1e-9)

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.records.items() if v}

    def report(self, extra: Optional[Dict] = None) -> str:
        """Benchmark-report JSON (ref: cli/core/util.py report shape)."""
        body = {
            "host": platform.node(),
            "machine": platform.machine(),
            "python": platform.python_version(),
            "stages_ms": {k: round(v * 1e3, 3)
                          for k, v in self.summary().items()},
        }
        if extra:
            body.update(extra)
        return json.dumps(body, indent=2)


def _add_spans(path: str, spans: List[SpanRecord]) -> None:
    """Write `spans` into the Chrome trace at `path`, on the trace's own
    time base, one complete event each in its thread's row."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds")
    if base is None:
        return
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "cpu_us": s.cpu_ns / 1e3,
                  "key": s.key}}
        for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Trace the CPU and, where there is one, the CUDA device with
    torch.profiler; on exit the Chrome trace (viewable in Perfetto or
    chrome://tracing) is written as trace.json under `log_dir` (by default
    ouster_sdk_tpu_torch_trace in the temporary directory), with the
    program's spans of the window beside the profiler's events. Yields the
    directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "ouster_sdk_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield log_dir
    t1 = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in snapshot().spans
                      if s.start_ns >= t0 and s.end_ns <= t1])
