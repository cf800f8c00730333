"""The program's own spans and counts in a traced run, placed on the
device trace's timeline.

The program records them with its tracer (ouster_sdk_tpu_torch.utils.
profiling), on `time.time_ns()`, while the profiler records (the traced
run). After the window this module reads `profiling.snapshot()` and places
each span on the timeline of trace.profiler_events through one anchor: the
driver's `t0`, `time.perf_counter()` at the window's start, is the
window's start `run.lo`; the snapshot's clock pair turns `time_ns` into
`perf_counter`. Spans are clipped to the window and counts outside it are
dropped. A program without the tracer (an older commit) gives nothing,
and every reader of it then reads None.

The anchor places the program's spans early by the time between the
window's profiler range and the driver's `t0`: in a fresh process the
profiler's first range on a thread sets that thread up after stamping its
start (0.28-0.37 ms on the H100's host, 1.4 ms on a shared CPU host). The
profiler stamps `time_ns`'s clock, so a run that knew the trace's start in
`time_ns` would place them exactly (`place(snap, trace_start_ns, 0.0,
...)`); the harness keeps no such reading.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import trace

#: (name, start, end, thread, thread CPU seconds) on the trace's timeline
Placed = Tuple[str, float, float, int, float]


@dataclass
class Program:
    spans: List[Placed]          # as placed, not clipped
    counts: List[Tuple[str, float, int]]   # (name, time, n) in the window
    main: int                    # the main thread's native id
    lo: float
    hi: float
    dropped: int

    def clipped(self, name: Optional[str] = None) -> List[Placed]:
        """The spans (named `name`, or all) clipped to the window; those
        wholly outside it left out."""
        out = []
        for n, a, b, t, c in self.spans:
            if name is not None and n != name:
                continue
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                out.append((n, a, b, t, c))
        return out

    def main_spans(self) -> List[trace.Interval]:
        """The main thread's spans, clipped, as trace intervals."""
        return [(n, a, b) for n, a, b, t, _ in self.clipped()
                if t == self.main]


def anchor(snap, t0: float) -> int:
    """The time_ns reading of the perf_counter reading `t0` (seconds), by
    the snapshot's clock pair."""
    time_ns, perf_ns = snap.clock
    return time_ns + round(t0 * 1e9) - perf_ns


def place(snap, ref_ns: int, ref_s: float, lo: float, hi: float,
          main: int) -> Program:
    """Place a profiling.Snapshot on the trace's timeline, where the
    time_ns reading `ref_ns` lies at `ref_s` seconds; the window is
    [lo, hi]."""

    def at(ns: int) -> float:
        return ref_s + (ns - ref_ns) * 1e-9

    spans = [(s.name, at(s.start_ns), at(s.end_ns), s.thread,
              s.cpu_ns * 1e-9) for s in snap.spans]
    counts = [(c.name, t, c.n) for c in snap.counts
              for t in (at(c.time_ns),) if lo <= t <= hi]
    return Program(spans, counts, main, lo, hi, snap.dropped)


def _snapshot():
    try:
        from ouster_sdk_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


def of(run) -> Optional[Program]:
    """The program's spans and counts of a finished traced run (read once
    and kept on the run); None without the tracer or a traced window."""
    if hasattr(run, "_program"):
        return run._program
    prog = None
    t0 = getattr(run.driver, "t0", None)
    if t0 is not None and run.hi > run.lo:
        snap = _snapshot()
        if snap is not None:
            prog = place(snap, anchor(snap, t0), run.lo, run.lo, run.hi,
                         threading.main_thread().native_id)
    run._program = prog
    return prog


def span_ms_per_unit(run, name: str) -> Optional[float]:
    """Milliseconds of the program's span `name` (every thread, clipped to
    the window) a unit of work; None where it was not recorded."""
    prog = of(run)
    if prog is None or run.units == 0:
        return None
    spans = prog.clipped(name)
    if not spans:
        return None
    return sum(s[2] - s[1] for s in spans) * 1e3 / run.units


def count_per_unit(run, name: str) -> Optional[float]:
    """The program's counter `name` over the window, a unit of work."""
    prog = of(run)
    if prog is None or run.units == 0:
        return None
    ns = [n for c, _, n in prog.counts if c == name]
    return sum(ns) / run.units if ns else None


def idle_gaps(device: List[trace.Interval], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The device's idle intervals inside [lo, hi]."""
    gaps, t = [], lo
    for a, b in trace.union(device, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    return gaps


def pieces(spans: List[trace.Interval], lo: float, hi: float
           ) -> List[Tuple[float, float, str]]:
    """[lo, hi] cut wherever one of `spans` (one thread's: they nest)
    opens or closes, each piece named after the innermost span open in
    it, the one opened last ("none" where none is)."""
    cuts = sorted({lo, hi} | {x for _, a, b in spans for x in (a, b)
                              if lo < x < hi})
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, active, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        while k < len(order) and order[k][1] <= mid:
            active.append(order[k])
            k += 1
        active = [s for s in active if s[2] > mid]
        out.append((a, b, active[-1][0] if active else "none"))
    return out


def idle_by_span(device: List[trace.Interval], spans: List[trace.Interval],
                 lo: float, hi: float) -> Dict[str, float]:
    """Seconds of the device's idle time inside [lo, hi] by the innermost
    of `spans` open ("none": none is), each gap split where that span
    changes."""
    tot: Dict[str, float] = defaultdict(float)
    cut = pieces(spans, lo, hi)
    k = 0
    for a, b in idle_gaps(device, lo, hi):
        while k < len(cut) and cut[k][1] <= a:
            k += 1
        j = k
        while j < len(cut) and cut[j][0] < b:
            x, y = max(a, cut[j][0]), min(b, cut[j][1])
            if y > x:
                tot[cut[j][2]] += y - x
            j += 1
    return dict(tot)


def idle_of(run) -> Optional[Dict[str, float]]:
    """The window's device idle time by the innermost program span open
    on the main thread (idle_by_span); None without a device trace or
    the program's spans."""
    prog = of(run)
    if prog is None or not run.device:
        return None
    return idle_by_span(run.device, prog.main_spans(), prog.lo, prog.hi)


def cpu_share(run, name: str) -> Optional[float]:
    """The thread CPU time of the program's spans `name` over their wall
    time (whole spans; the tracer records only in the traced window)."""
    prog = of(run)
    if prog is None:
        return None
    mine = [(b - a, c) for n, a, b, _, c in prog.spans if n == name]
    wall = sum(w for w, _ in mine)
    return sum(c for _, c in mine) / wall if wall > 0 else None


def contained(prog: Program, bench: List[trace.Interval],
              pairs: List[Tuple[str, str]], tol: float = 0.5e-3
              ) -> Dict[str, Tuple[int, int]]:
    """For each (prefix, benchmark span) pair: (inside, of) the main
    thread's program spans whose name starts with `prefix`, and how many
    of them lie inside a benchmark span of that name within `tol`
    seconds: a check of the placement on the timeline."""
    out = {}
    for prefix, outer in pairs:
        bs = [(a, b) for n, a, b in bench if n == outer]
        mine = [(a, b) for n, a, b, t, _ in prog.spans
                if t == prog.main and n.startswith(prefix)]
        inside = sum(1 for a, b in mine
                     if any(x - tol <= a and b <= y + tol for x, y in bs))
        out[f"{prefix} in {outer}"] = (inside, len(mine))
    return out
