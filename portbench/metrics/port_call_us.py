"""Host time of a traced call of the port's K2/K3 wrapper, from inside it:
the sum of its four phases' means (``port_checks_us``, ``port_pack_us``,
``port_alloc_us``, ``port_launch_us``), μs a call."""
from portbench.program_spans import call_us


def read(run):
    return call_us()
