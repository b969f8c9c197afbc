"""Chrome-trace span recording with stable pid/tid lane conventions.

One :class:`Tracer` accumulates complete ("ph": "X") spans from every
subsystem into a single ``chrome://tracing`` / Perfetto timeline. Lane
conventions (trace *processes*) are fixed so simulator and fleet spans
group predictably side by side:

  ============  ===================================================
  pid lane      rows (tids)
  ============  ===================================================
  ``events``    one per tenant instance — whole-event spans (sim)
  ``tiles``     one per AIE tile — compute spans (sim)
  ``fifo``      cascade / shared-memory FIFOs (sim)
  ``dma``       DMA routes (sim)
  ``shim``      one per shim column — PLIO transfers (sim)
  ``fleet``     one per serving replica + a ``dispatch`` row (runtime)
  ``dse``       one per model — search phase spans
  ============  ===================================================

Timestamps are microseconds (the Chrome-trace unit). Simulated spans are
converted from AIE cycles by :class:`repro_torch.sim.trace.ChromeTrace` (a
subclass of this Tracer); runtime spans use the tracer's wall clock
(:meth:`Tracer.now_us` / :meth:`Tracer.region`), anchored at tracer
construction so a run starts near t=0.

Beside it, :data:`spans` (a :class:`HotSpans`, kept in
:mod:`repro_torch.kernels._build` so that the kernel wrappers import it
without this package) times the port's K2/K3 wrappers from inside, only while
a ``torch.profiler`` records: each call is a run of flat, successive profiler
ranges (checks, packed weights, output, launch) on the clock the profiler
shares with the device's kernels and copies, whose host nanoseconds add up by
name. With no profiler recording, a wrapper's call costs one query of the
profiler's state.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from repro_torch.kernels._build import HotSpans, spans  # noqa: F401

#: Stable pid numbering so lanes group predictably in the viewer. New pid
#: names allocate increasing ids per tracer instance.
DEFAULT_PIDS = {"events": 1, "tiles": 2, "fifo": 3, "dma": 4, "shim": 5,
                "fleet": 6, "dse": 7}


class Tracer:
    """Accumulates complete ("ph": "X") spans plus naming metadata."""

    def __init__(self, *, meta: Optional[dict] = None,
                 pids: Optional[Dict[str, int]] = None) -> None:
        self.events: List[dict] = []
        self.meta = dict(meta or {})
        self._pids: Dict[str, int] = dict(pids or DEFAULT_PIDS)
        self._tids: Dict[str, Dict[str, int]] = {}
        self._wall0 = time.perf_counter()

    # -- lane bookkeeping ----------------------------------------------------
    def pid(self, pid_name: str) -> int:
        p = self._pids.get(pid_name)
        if p is None:
            p = self._pids[pid_name] = max(self._pids.values(), default=0) + 1
        return p

    def _ids(self, pid_name: str, tid_name: str) -> tuple:
        pid = self.pid(pid_name)
        tids = self._tids.setdefault(pid_name, {})
        tid = tids.get(tid_name)
        if tid is None:
            tid = tids[tid_name] = len(tids) + 1
            self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                                "tid": tid, "args": {"name": tid_name}})
            if len(tids) == 1:
                self.events.append({"ph": "M", "name": "process_name",
                                    "pid": pid, "tid": 0,
                                    "args": {"name": pid_name}})
        return pid, tid

    # -- recording ------------------------------------------------------------
    def span_us(self, pid_name: str, tid_name: str, name: str, ts_us: float,
                dur_us: float, *, cat: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        pid, tid = self._ids(pid_name, tid_name)
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": ts_us, "dur": dur_us}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant_us(self, pid_name: str, tid_name: str, name: str,
                   ts_us: float) -> None:
        pid, tid = self._ids(pid_name, tid_name)
        self.events.append({"ph": "i", "name": name, "pid": pid, "tid": tid,
                            "ts": ts_us, "s": "t"})

    def flow_us(self, pid_name: str, tid_name: str, name: str, ts_us: float,
                *, id: int, phase: str, cat: str = "flow") -> None:
        """One endpoint of a flow arrow ("s" start / "f" finish).

        Chrome/Perfetto bind the endpoint to the enclosing "X" slice at the
        same pid/tid whose interval covers ``ts_us``, and match arrows by
        (cat, name, id) — so emit both endpoints with the same id. Used by
        :func:`repro_torch.obs.profile.add_flow_events` to draw the causal edges
        of each event's critical path across the task spans.
        """
        if phase not in ("s", "f"):
            raise ValueError(f"flow phase must be 's' or 'f', got {phase!r}")
        pid, tid = self._ids(pid_name, tid_name)
        ev = {"ph": phase, "cat": cat, "name": name, "id": id,
              "pid": pid, "tid": tid, "ts": ts_us}
        if phase == "f":
            ev["bp"] = "e"       # bind to the enclosing slice's end point
        self.events.append(ev)

    # -- wall clock ------------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since tracer construction (wall clock)."""
        return (time.perf_counter() - self._wall0) * 1e6

    def wall_us(self, t_perf_counter: float) -> float:
        """Convert a raw ``time.perf_counter()`` reading to trace time."""
        return (t_perf_counter - self._wall0) * 1e6

    @contextmanager
    def region(self, pid_name: str, tid_name: str, name: str, *,
               cat: Optional[str] = None, args: Optional[dict] = None):
        """Record the wrapped block as one wall-clock span."""
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.span_us(pid_name, tid_name, name, t0, self.now_us() - t0,
                         cat=cat, args=args)

    # -- export ----------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ns",
                "otherData": self.meta}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path

    def spans(self, pid_name: Optional[str] = None) -> List[dict]:
        """Complete spans, optionally filtered to one process lane."""
        want = self._pids.get(pid_name) if pid_name else None
        return [e for e in self.events if e["ph"] == "X"
                and (want is None or e["pid"] == want)]


def load(path: str) -> dict:
    """Load + structurally validate a Chrome trace written by :class:`Tracer`."""
    with open(path) as f:
        data = json.load(f)
    if "traceEvents" not in data or not isinstance(data["traceEvents"], list):
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents list)")
    for ev in data["traceEvents"]:
        if ev["ph"] == "X" and (ev["dur"] < 0 or ev["ts"] < 0):
            raise ValueError(f"{path}: negative span {ev}")
    return data
