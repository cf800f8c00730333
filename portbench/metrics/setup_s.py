"""setup_s (s): from the start of the process to the start of the window:
imports, the synthesized capture, loading the kernels, building the pipeline
and warming every shape the window uses."""


def read(run):
    return run.setup_s
