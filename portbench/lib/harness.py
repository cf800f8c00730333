"""One run of one cell: set-up (timed), the measured window (traced or
not), the metrics of the cell, the check of what the window produced, and
the result line.

A driver module (drivers/<name>.py) holds `Driver(cell, seed, device,
variant, workdir)` with:
    setup()          make the inputs, build and warm the program
    window(seconds, spans) -> None
                     drive the program for `seconds`; set .units,
                     .window_s, .attempted, .failed and .calls
    release()        free the program's state before the reference runs
    check() -> [(name, value, limit)]
                     each number compared with its limit (value <= limit
                     is correct)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from . import spec, trace

# top-level module names no run may load (compared whole: the program's
# package name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "ouster_sdk_tpu", "bench", "chip_smoke")


def banned_modules(modules=None) -> List[str]:
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(BANNED))


def count_passes(passes, n: int):
    """(attempted, lost) over the passes of a window: each pass's frame ids
    against 1..n (1..its length for the pass the window's end cut), a
    missing, extra or wrong id counting as one lost."""
    attempted = lost = 0
    for ids, whole in passes:
        want = np.arange(1, (n if whole else len(ids)) + 1)
        attempted += len(want)
        m = min(len(ids), len(want))
        lost += int(np.count_nonzero(ids[:m] != want[:m])) \
            + abs(len(want) - len(ids))
    return attempted, lost


def refuse_banned() -> bool:
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
    return bool(found)


@dataclass
class Run:
    """What a metric's reader sees of a finished window."""

    cell: spec.Cell
    driver: object
    setup_s: float
    spans: trace.Spans
    device: List[trace.Interval] = field(default_factory=list)
    host_spans: List[trace.Interval] = field(default_factory=list)
    lo: float = 0.0
    hi: float = 0.0

    @property
    def units(self) -> int:
        return self.driver.units

    @property
    def unit(self) -> str:
        return self.cell.traffic["unit"]

    @property
    def window_s(self) -> float:
        return self.driver.window_s

    @property
    def calls(self) -> Dict[str, List[int]]:
        return self.driver.calls


def _device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the benchmark); cpu only for the tests")
    p.add_argument("--variant", default="",
                   help="'control': the cell's lower-precision control in "
                        "the program's place (never in a benchmark run)")
    p.add_argument("--root", default=spec.HERE,
                   help="the benchmark's folder (a copy, in the tests)")
    return p.parse_args(argv)


def run(argv, t_start: float, out=None) -> int:
    args = parse(argv)
    out = out or sys.stdout
    try:
        cell = spec.find_cell(args.workload, args.root)
    except KeyError:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    drv = cell.driver().Driver(cell, args.seed, device, args.variant,
                               os.path.join(args.root, "_cache", cell.name))
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    spans = trace.Spans(on=bool(args.trace))
    r = Run(cell=cell, driver=drv, setup_s=setup_s, spans=spans)
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with spans.span(trace.WINDOW):
                drv.window(args.seconds, spans)
        spans.unwrap()
        r.device, r.host_spans = trace.profiler_events(prof)
        win = [s for s in r.host_spans if s[0] == trace.WINDOW]
        if win:
            r.lo, r.hi = win[0][1], win[0][2]
        del prof
    else:
        drv.window(args.seconds, spans)
    dev_info = _device_info(torch, device, cell.chips)

    if refuse_banned():
        return 3

    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"]).read(r)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"metrics": metrics, "device": dev_info}
    if args.trace:
        dev_info["busy_s"] = trace.busy_s(r.device, r.lo, r.hi)
        dev_info["window_s"] = r.hi - r.lo
        line["breakdown"] = {
            "device_ops": trace.by_name(r.device, r.lo, r.hi),
            "idle_gaps": trace.idle_by_span(r.device, r.host_spans, r.lo,
                                            r.hi)}

    drv.release()
    checks = drv.check()
    correct = drv.failed == 0 and all(v <= lim for _, v, lim in checks)
    line = {"correct": correct, "attempted": drv.attempted,
            "failed": drv.failed, **line,
            # a number that could not be read (nothing sampled) is null:
            # JSON has no infinity
            "checks": {n: {"value": v if math.isfinite(v) else None,
                           "limit": lim} for n, v, lim in checks}}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"check failed: {drv.failed} of {drv.attempted} {r.unit}",
          file=sys.stderr)
    if refuse_banned():
        return 3
    print(json.dumps(line), file=out, flush=True)
    return 0
