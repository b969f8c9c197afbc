"""Events whose call completed inside the window, over the window's length
on the host's clock (a call of the cell's batch is ``batch_events`` events;
an event is what the port serves as one: an (m, f) set or (rows, f))."""


def read(run):
    return run.window.done * run.batch_events / run.window.seconds
