"""The program's own spans and counts in the benchmark (lib/program_trace.py
and the metrics that read them): the placement on the trace's timeline on
a hand-made snapshot, a value of every such metric in a traced CPU run of
each cell at 16 x 256, and the program's main-thread spans inside the
benchmark span that wraps the same call."""

import json
import math
import os
import threading
from types import SimpleNamespace

import pytest

from conftest import ROOT, run_cell

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SLAM = "os2-128-2048x10-dual.slam"
REPLAY_PAIRS = [("frames.queue_wait", "staging"), ("h2d_copy", "project"),
                ("project.issue", "project"), ("destagger", "project")]
# (program span prefix, the benchmark span around its call), by cell
PAIRS = {
    "os2-128-2048x10-dual.device_xyz": REPLAY_PAIRS,
    "os2-128-1024x10-single.device_xyz": REPLAY_PAIRS,
    "os2-128-2048x10-dual.scans": [
        ("engine.", "source"), ("frames.", "source"), ("h2d_copy", "source"),
        ("xyzlut", "xyzlut")],
    SLAM: [("engine.", "source"), ("slam.gather", "gather"),
           ("slam.voxelize", "register"), ("slam.threshold", "register"),
           ("icp.", "register"), ("map.", "register"),
           ("map.", "map_update")],
}


def program_metrics(cell):
    return [m["name"] for m in BENCHMARK["per_layer"]
            if m["source"] in ("program_span", "program_counter")
            and cell in m["workloads"]]


def snapshot(spans, counts, clock):
    from ouster_sdk_tpu_torch.utils.profiling import (CountRecord,
                                                      SpanRecord, Snapshot)

    return Snapshot([SpanRecord(n, a, b, t, 0, c, None, k + 1)
                     for k, (n, a, b, t, c) in enumerate(spans)],
                    [CountRecord(n, t, v, 1) for n, t, v in counts],
                    clock, 0)


def test_the_anchor_and_the_window():
    from portbench.lib import program_trace as pt_

    # time_ns 10**12 was perf_counter 5 s; the window starts at perf
    # 5.5 s, which is 2.0 s on the trace's timeline, and lasts 1 s
    tn, pc = 10**12, 5 * 10**9
    at = lambda s: tn + int((s - 5.0) * 1e9)   # perf seconds -> time_ns
    snap = snapshot([("a", at(5.6), at(5.7), 1, 50_000_000),
                     ("b", at(5.4), at(5.6), 2, 0),      # starts before
                     ("c", at(6.4), at(6.9), 1, 0),      # ends after
                     ("d", at(7.0), at(7.1), 1, 0)],     # outside
                    [("n", at(5.55), 2), ("n", at(5.2), 5),
                     ("n", at(6.6), 9)], (tn, pc))
    ref = pt_.anchor(snap, 5.5)
    assert ref == at(5.5)
    prog = pt_.place(snap, ref, 2.0, 2.0, 3.0, 1)
    a = prog.spans[0]
    assert a[:4] == pytest.approx(("a", 2.1, 2.2, 1)) and a[4] == 0.05
    clipped = {s[0]: s[1:3] for s in prog.clipped()}
    assert set(clipped) == {"a", "b", "c"}
    assert clipped["b"] == pytest.approx((2.0, 2.1))
    assert clipped["c"] == pytest.approx((2.9, 3.0))
    assert prog.counts == [("n", pytest.approx(2.05), 2)]
    assert [s[0] for s in prog.main_spans()] == ["a", "c"]
    run = SimpleNamespace(units=4, _program=prog, device=[
        ("k", 2.0, 2.15), ("k", 2.5, 2.6)], lo=2.0, hi=3.0)
    assert pt_.span_ms_per_unit(run, "c") == pytest.approx(25.0)
    assert pt_.span_ms_per_unit(run, "d") is None
    assert pt_.count_per_unit(run, "n") == pytest.approx(0.5)
    assert pt_.cpu_share(run, "a") == pytest.approx(0.5)
    # idle: [2.15, 2.5) and [2.6, 3.0); main spans cover [2.1, 2.2) and
    # [2.9, 3.0): 0.05 under a, 0.1 under c, 0.3 + 0.3 under none
    assert pt_.idle_of(run) == pytest.approx({"a": 0.05, "c": 0.1,
                                              "none": 0.6})
    from portbench.lib.spec import load_module

    reader = load_module(os.path.join(ROOT, "portbench", "readers",
                                      "device_idle_untraced_pct.py"), "x")
    assert reader.read(run) == pytest.approx(60.0)
    # nested spans: the innermost open one holds each piece
    nest = [("out", 0.0, 1.0), ("in", 0.2, 0.4), ("in2", 0.6, 0.7)]
    assert pt_.pieces(nest, 0.0, 1.0) == [
        (0.0, 0.2, "out"), (0.2, 0.4, "in"), (0.4, 0.6, "out"),
        (0.6, 0.7, "in2"), (0.7, 1.0, "out")]
    assert pt_.idle_by_span([("k", 0.3, 0.65)], nest, 0.0, 1.2) == \
        pytest.approx({"out": 0.5, "in": 0.1, "in2": 0.05, "none": 0.2})
    ok = pt_.contained(prog, [("outer", 2.05, 2.3)], [("a", "outer"),
                                                      ("c", "outer")])
    assert ok == {"a in outer": (1, 1), "c in outer": (0, 1)}


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    from portbench.lib import program_trace as pt_
    from ouster_sdk_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    from portbench.lib.spec import load_module

    reader = load_module(os.path.join(ROOT, "portbench", "readers",
                                      "device_idle_untraced_pct.py"), "y")
    for read in (lambda r: pt_.span_ms_per_unit(r, "h2d_copy"),
                 lambda r: pt_.count_per_unit(r, "icp.host_syncs"),
                 reader.read):
        run = SimpleNamespace(driver=SimpleNamespace(t0=1.0), lo=0.0,
                              hi=1.0, units=3, device=[("k", 0.1, 0.2)])
        assert read(run) is None


@pytest.mark.parametrize("cell", sorted(PAIRS))
def test_traced_run_reads_every_program_metric(tiny, cell, monkeypatch):
    from portbench.lib import harness, program_trace, trace
    from ouster_sdk_tpu_torch.utils import profiling

    runs, start = [], []
    make, events = harness.Run, trace.profiler_events

    def keep(*args, **kwargs):
        runs.append(make(*args, **kwargs))
        return runs[-1]

    def kept_start(prof):
        start.append(prof.profiler.kineto_results.trace_start_ns())
        return events(prof)

    monkeypatch.setattr(harness, "Run", keep)
    monkeypatch.setattr(trace, "profiler_events", kept_start)
    profiling.clear()
    rc, line = run_cell(tiny, cell, "--trace", "1",
                        seconds=5.0 if cell == SLAM else 1.0)
    assert rc == 0 and line["correct"] is True, line["checks"]
    for name in program_metrics(cell):
        v = line["metrics"].get(name, {}).get("value")
        assert v is not None and math.isfinite(v) and v > 0, name
    # no device on the CPU: the device metrics read nothing
    assert not [n for n in line["metrics"] if n.startswith("device_idle")]
    (run,) = runs
    prog = program_trace.of(run)
    assert prog.main == threading.main_thread().native_id
    assert prog.dropped == 0
    assert program_trace.cpu_share(run, "frames.stage_chunk" if cell != SLAM
                                   else "slam.gather") > 0
    # placed by the trace's start (the profiler stamps time_ns's clock),
    # each main-thread span lies in the benchmark span around its call
    snap = profiling.snapshot()
    exact = program_trace.place(snap, start[0], 0.0, run.lo, run.hi,
                                prog.main)
    for pair, (inside, total) in program_trace.contained(
            exact, run.host_spans, PAIRS[cell]).items():
        assert total > 0 and inside == total, (pair, inside, total)
    # the benchmark's anchor (the driver's t0 at the window's start) is
    # late by the profiler's set-up of its first range, never early
    late = (program_trace.anchor(snap, run.driver.t0) - start[0]) * 1e-9 \
        - run.lo
    assert 0 < late < 0.01
