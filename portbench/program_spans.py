"""The port's own spans (``repro_torch.obs.tracing.spans``), for the
metrics that read them. The port records a wrapper's call, in its phases,
only while a profiler runs, so in a traced run they are the traced stretch's
calls; the library's first load it records always. A program without the
recorder reads None."""
from __future__ import annotations

from typing import Optional

#: A wrapper call's phases, in order; each starts where the last one ended.
PHASES = ("repro_torch.checks", "repro_torch.pack", "repro_torch.alloc",
          "repro_torch.launch")


def recorder():
    try:
        from repro_torch.obs.tracing import spans
    except ImportError:
        return None
    return spans


def mean_us(name: str) -> Optional[float]:
    """Host microseconds a span of ``name``; None where there was none."""
    r = recorder()
    return None if r is None else r.mean_us(name)


def call_us() -> Optional[float]:
    """Host microseconds a call: the sum of its phases' means; None where no
    phase was recorded."""
    means = [m for m in map(mean_us, PHASES) if m is not None]
    return sum(means) if means else None


def total_s(name: str) -> Optional[float]:
    """Host seconds of every span of ``name``; None where there was none."""
    r = recorder()
    tot = {} if r is None else r.totals()
    return tot[name][1] * 1e-9 if name in tot else None
