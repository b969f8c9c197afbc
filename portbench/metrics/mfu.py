"""The whole step's share of the card's peak, in %: the operations the
algorithm needs for every event completed in the window (``ops_per_event``
of the configuration's reference, at the published widths), over the
window's length times the data-sheet peak at the configuration's precision
(``roofline.PEAKS``; int8 where the configuration names no ``"peak"``)."""


def read(run):
    if run.peak is None:
        return None
    ops = run.window.done * run.batch_events * run.ref.ops_per_event(
        run.config)
    return 100.0 * ops / (run.window.seconds * run.peak[0])
