"""The 95th percentile, over every call of the window, of the time from
handing the batch to the port until its scores are in host memory (linear
interpolation between the two nearest of all samples, as
``numpy.percentile``). Only traffic that copies its scores out has it."""
import numpy as np


def read(run):
    lat = run.window.latencies_us
    return float(np.percentile(lat, 95)) if lat else None
