"""wire_launches_per_frame (launches/frame), traced run: kernels that ran on
the card in the window (device operations of the profiler's trace other
than copies and fills) a frame completed."""

from portbench.lib import trace


def read(run):
    if not run.device or run.units == 0:
        return None
    return trace.kernel_count(run.device, run.lo, run.hi) / run.units
