"""Traffic loops, one module each, named by a traffic mix's ``loop``: each
has ``drive(fn, pool, traffic, w, *, stream, seconds, limit, sample,
label)``, which fills the ``window.Window`` ``w``."""
