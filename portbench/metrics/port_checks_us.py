"""Host time of the wrapper's argument, device and layout checks and the
set's padding arithmetic (span ``repro_torch.checks``): mean μs a traced
call."""
from portbench.program_spans import mean_us


def read(run):
    return mean_us("repro_torch.checks")
