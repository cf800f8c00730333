"""planar_project_roofline (%), traced run: the least time the card could take
for the window's planar_project calls (their bytes, counted by
lib/roofline.py from each call's frames, over the HBM peak) as a share of
the device time of the planar_project kernels in the profiler's trace.
Nothing where the trace holds no such kernel, or not one a call."""

from portbench.lib import roofline, trace
from portbench.lib.synth import Sensor


def read(run):
    calls = run.calls.get("planar_project", [])
    secs, n = trace.kernel_time(run.device, "planar_project", run.lo,
                                run.hi)
    if not calls or n != len(calls) or secs <= 0:
        return None
    s = Sensor(run.cell.config["metadata"])
    nbytes = sum(roofline.planar_project_bytes(b, s.h, s.w, len(s.returns))
                 for b in calls)
    return nbytes / roofline.PEAK_BYTES_PER_S / secs * 100
