"""Seconds of the kernel library's first load in the process (span
``repro_torch.library``, kept whether or not a profiler runs): the sources'
hash, nvcc where the checkout has no build of them, the ctypes load."""
from portbench.program_spans import total_s


def read(run):
    return total_s("repro_torch.library")
