"""Share of the traced window in which no operation ran on the device, in
% (``devtrace``); in the trigger cells it moves the decisions' p95."""
from portbench.devtrace import idle_share


def read(run):
    return idle_share(run.trace)
