"""The port's kernel launches in the window (``repro_torch.kernels.launches``,
counted by its wrappers) over the calls issued."""


def read(run):
    if run.launches is None or not run.window.issued:
        return None
    return run.launches / run.window.issued
