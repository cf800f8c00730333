"""Milliseconds of the program's own span `span` (its tracer, every
thread, clipped to the window) a unit of work in the window (traced run);
nothing where the program recorded no such span."""

from portbench.lib.program_trace import span_ms_per_unit


def read(run, span):
    return span_ms_per_unit(run, span)
