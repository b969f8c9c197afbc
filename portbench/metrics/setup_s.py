"""Seconds from the process's start to the window's: imports, the kernels'
library (built on a checkout's first run), the seeded model and its PTQ,
the event pool on the device, the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
