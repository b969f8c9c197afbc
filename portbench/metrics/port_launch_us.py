"""Host time of the launch: the library, the stream, the C entry point
(which calls ``cudaLaunchKernel``), its error check and the launch count
(span ``repro_torch.launch``): mean μs a traced call."""
from portbench.program_spans import mean_us


def read(run):
    return mean_us("repro_torch.launch")
