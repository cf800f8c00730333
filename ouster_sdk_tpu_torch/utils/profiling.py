"""Profiling helpers: wall/cpu timers + device traces.

The reference ships benchmark harnesses but no tracer (ref: SURVEY.md §5.1);
this package adds torch.profiler traces (CPU and CUDA activities, written
as a Chrome trace) for device timelines, plus the same report-JSON shape as
`ouster-cli util benchmark` (ref: cli/core/util.py:180-310).
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import tempfile
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterator, List, Optional


@dataclass
class ProfileRunner:
    """Accumulates wall/cpu time per named stage
    (ref: python/tests/test_performance.py:21-51 ProfileRunner)."""

    records: Dict[str, List[float]] = dc_field(default_factory=dict)

    @contextlib.contextmanager
    def run(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        c0 = time.process_time()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(
                time.perf_counter() - t0)
            self.records.setdefault(name + "_cpu", []).append(
                time.process_time() - c0)

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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Trace the CPU and, where there is one, the CUDA device with
    torch.profiler; on exit the Chrome trace (viewable in Perfetto or
    chrome://tracing) is written as trace.json under `log_dir` (by default
    ouster_sdk_tpu_torch_trace in the temporary directory). Yields the
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
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
