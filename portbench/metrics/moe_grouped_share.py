"""Share of the traced MoE layers that ran their held experts in one
grouped launch (K6) rather than the loop over the experts: counter
``repro_torch.moe.grouped`` (each traced layer adds 1 for K6, 0 for the
loop), its sum over its count, in %. None where the program has no such
counter or counted no layer."""
from portbench.program_spans import recorder


def read(run):
    r = recorder()
    counts = getattr(r, "counts", None)
    if counts is None:
        return None
    n, grouped = counts().get("repro_torch.moe.grouped", (0, 0))
    return 100.0 * grouped / n if n else None
