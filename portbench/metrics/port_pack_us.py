"""Host time of the packed weights' lookups and the shared-memory
arithmetic (span ``repro_torch.pack``): mean μs a traced call."""
from portbench.program_spans import mean_us


def read(run):
    return mean_us("repro_torch.pack")
