"""Host time of the output's ``torch.empty`` (span ``repro_torch.alloc``):
mean μs a traced call."""
from portbench.program_spans import mean_us


def read(run):
    return mean_us("repro_torch.alloc")
