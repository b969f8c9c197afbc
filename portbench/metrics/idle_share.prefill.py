"""Share of the traced window in which no operation ran on the device, in
% (``devtrace``); in the prefill cell, the host's share of a prefill (the
MoE's syncs, the launches) that the device waits on."""
from portbench.devtrace import idle_share


def read(run):
    return idle_share(run.trace)
