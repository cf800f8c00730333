"""Every unit of work completed in the window over the window's length
(host clock; the window ends once the last chunk or scan is complete), in a
cell whose mix counts `unit`."""


def read(run, unit):
    if run.unit != unit or run.window_s <= 0:
        return None
    return run.units / run.window_s
