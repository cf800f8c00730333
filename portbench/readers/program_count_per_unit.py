"""The program's own counter `counter` (its tracer) over the window, a unit
of work in the window (traced run); nothing where the program counted
none."""

from portbench.lib.program_trace import count_per_unit


def read(run, counter):
    return count_per_unit(run, counter)
