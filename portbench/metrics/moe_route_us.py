"""Host time of a MoE layer's routing: the router, its top-k and the
dispatch's sort and counts as the host issues them, up to the host's wait
for the held experts' counts, which is span ``repro_torch.moe.sync`` and not
counted here (span ``repro_torch.moe.route``): mean μs a traced layer; None
where the program recorded none."""
from portbench.program_spans import mean_us


def read(run):
    return mean_us("repro_torch.moe.route")
