"""Milliseconds of the benchmark span `span` a unit of work in the window
(traced run)."""

from portbench.lib.trace import span_per_unit


def read(run, span):
    return span_per_unit(run, span)
