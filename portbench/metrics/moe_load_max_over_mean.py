"""How unevenly the held experts are loaded: in each traced MoE layer, the
rows of its busiest held expert over the mean of its held experts' rows,
averaged over the layers (counter ``repro_torch.moe.load_max_over_mean``).
1 is an even load. None where the program has no counters or counted no
layer."""
from portbench.program_spans import recorder


def read(run):
    r = recorder()
    counts = getattr(r, "counts", None)
    if counts is None:
        return None
    n, total = counts().get("repro_torch.moe.load_max_over_mean", (0, 0))
    return total / n if n else None
