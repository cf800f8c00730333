"""The share (%) of the traced window in which no kernel and no copy ran on
the card: the union of the device operations of the profiler's trace,
against the window's length."""

from portbench.lib import trace


def read(run):
    if not run.device or run.hi <= run.lo:
        return None
    return 100 * (1 - trace.busy_s(run.device, run.lo, run.hi)
                  / (run.hi - run.lo))
