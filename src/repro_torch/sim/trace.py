"""Chrome-trace export of simulation runs, on the unified obs Tracer.

:class:`ChromeTrace` is :class:`repro_torch.obs.tracing.Tracer` with a *cycle*
clock: span/instant timestamps are AIE cycles, converted to microseconds
(the Chrome trace unit) at 1.25 GHz, so a ~600 ns inference renders as a
~0.6 us span. Lanes follow the shared pid conventions
(:data:`repro_torch.obs.tracing.DEFAULT_PIDS`): one trace *process* per resource
class — tiles, cascade/shared-memory FIFOs, DMA routes, shim columns — and
one "events" process with a row per tenant instance showing whole-event
spans. Because the base class also records wall-clock spans
(:meth:`~repro_torch.obs.tracing.Tracer.region`), one ChromeTrace can carry
simulator task spans and fleet serving spans in a single timeline.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import aie_arch
from repro_torch.obs.tracing import DEFAULT_PIDS, Tracer, load

#: Backward-compatible alias: the default pid numbering of the unified
#: tracer ("events": 1, "tiles": 2, "fifo": 3, "dma": 4, "shim": 5, ...).
PIDS = DEFAULT_PIDS

__all__ = ["ChromeTrace", "PIDS", "load"]


def _us(cycles: float) -> float:
    return cycles * aie_arch.NS_PER_CYCLE / 1000.0


class ChromeTrace(Tracer):
    """Unified tracer whose span/instant timestamps are AIE cycles."""

    def span(self, pid_name: str, tid_name: str, name: str, start_cycles: float,
             dur_cycles: float, *, cat: Optional[str] = None,
             args: Optional[dict] = None) -> None:
        self.span_us(pid_name, tid_name, name, _us(start_cycles),
                     _us(dur_cycles), cat=cat, args=args)

    def instant(self, pid_name: str, tid_name: str, name: str,
                t_cycles: float) -> None:
        self.instant_us(pid_name, tid_name, name, _us(t_cycles))

    def flow(self, pid_name: str, tid_name: str, name: str, t_cycles: float,
             *, id: int, phase: str, cat: str = "flow") -> None:
        """Cycle-clock flow endpoint (see :meth:`Tracer.flow_us`)."""
        self.flow_us(pid_name, tid_name, name, _us(t_cycles), id=id,
                     phase=phase, cat=cat)
