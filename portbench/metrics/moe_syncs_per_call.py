"""The host's waits on the card that the MoE layers make in a call of the
port's prefill: counter ``repro_torch.moe.syncs`` (each traced layer adds
the waits it made, as torch's sync debug mode reports them: a copy to the
host, ``.item()``, a ``bincount`` that sizes its output...) over the traced
calls (spans ``repro_torch.prefill``). None where the program has no
counters or recorded no prefill."""
from portbench.program_spans import recorder


def read(run):
    r = recorder()
    counts = getattr(r, "counts", None)
    if counts is None:
        return None
    calls = r.totals().get("repro_torch.prefill", (0, 0))[0]
    if not calls:
        return None
    return counts().get("repro_torch.moe.syncs", (0, 0))[1] / calls
