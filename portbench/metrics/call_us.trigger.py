"""Host time inside the port's call (checks, packed-weight lookup, launch:
the enqueue only), summed over the window's calls on the host's clock and
divided by their number."""


def read(run):
    if not run.window.issued:
        return None
    return run.window.call_s / run.window.issued * 1e6
