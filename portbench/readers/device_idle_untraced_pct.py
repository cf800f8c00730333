"""The share (%), traced run, of the window in which the card was idle (no
kernel, no copy in the profiler's trace) and no span of the program's own
tracer was open on the main thread: idle time that no program span
explains. Nothing without a device trace or without the program's
spans."""

from portbench.lib import program_trace


def read(run):
    idle = program_trace.idle_of(run)
    if not idle:
        return None
    return 100 * idle.get("none", 0.0) / (run.hi - run.lo)
