"""Minimal discrete-event engine: simulator clock, FIFO resources, task DAGs.

The engine is deliberately generic — it knows nothing about AIE tiles or
PLIO. :mod:`repro_torch.sim.array` instantiates the resources and
:mod:`repro_torch.sim.run` builds the task graphs. Three primitives:

  * :class:`Simulator` — a time-ordered event heap. Ties break by schedule
    order (a monotonically increasing sequence number), so runs are fully
    deterministic.
  * :class:`Resource` — a capacity-k server with a FIFO wait queue. Every
    grant/release is recorded as a busy span, which is what the trace export
    and the occupancy invariants (no tile double-booked) consume.
  * :class:`Task` — one activity: wait for all predecessors, wait ``delay``
    cycles, acquire a resource (or none), stay busy ``duration`` cycles,
    release, notify successors. A :class:`TaskGraph` runs a static DAG of
    tasks and raises :class:`DeadlockError` when the event heap drains with
    tasks still pending — the property tests assert this never happens for
    valid placements.

Causality recording: every task remembers which edge *released* it —
``Task.cause`` is the last-finishing predecessor (the dependency edge
that dropped ``_npreds`` to zero) and ``Task.granted_by`` is the task
whose resource release promoted it out of a FIFO queue (None when the
grant was immediate). Both are O(1) per task, so a completed run carries
its full causality DAG and :mod:`repro_torch.obs.profile` can walk the exact
per-event critical path backwards without re-running the schedule.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple


class DeadlockError(RuntimeError):
    """The event heap drained while tasks were still pending."""

    def __init__(self, unfinished: Sequence["Task"]):
        self.unfinished = list(unfinished)
        names = ", ".join(t.name for t in self.unfinished[:8])
        more = "" if len(self.unfinished) <= 8 else f" (+{len(self.unfinished) - 8} more)"
        super().__init__(
            f"deadlock: {len(self.unfinished)} task(s) never completed: "
            f"{names}{more}")


class Simulator:
    """Time-ordered event loop over a float cycle clock.

    Heap entries are plain ``(time, seq, fn)`` tuples — ``seq`` is unique,
    so the (uncomparable) callback is never reached by tuple comparison
    and ties still break by schedule order.
    """

    def __init__(self) -> None:
        self.now: float = 0.0
        self.events_run: int = 0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq: int = 0

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        self._seq += 1
        heapq.heappush(self._heap, (self.now + delay, self._seq, fn))

    def run(self, *, max_events: int = 5_000_000) -> int:
        heap = self._heap
        pop = heapq.heappop
        n = self.events_run
        try:
            while heap:
                t, _, fn = pop(heap)
                self.now = t
                fn()
                n += 1
                if n > max_events:
                    raise RuntimeError(
                        f"event budget exceeded ({max_events}) at t={self.now}")
        finally:
            self.events_run = n
        return n


class Resource:
    """Capacity-``capacity`` server with a FIFO wait queue.

    ``pid``/``tid`` name the trace lane this resource's busy spans render
    on; ``spans`` keeps ``(task_name, start, end, bytes)`` for invariant
    checks regardless of whether a trace recorder is attached.
    """

    def __init__(self, name: str, *, capacity: int = 1, pid: str = "",
                 tid: str = "") -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = capacity
        self.pid = pid or "resources"
        self.tid = tid or name
        self.spans: List[Tuple[str, float, float, int]] = []
        self.waits: int = 0
        self.wait_cycles: float = 0.0
        self.max_queued: int = 0
        self._busy: int = 0
        self._queue: Deque["Task"] = deque()

    def request(self, task: "Task") -> None:
        if self._busy < self.capacity:
            self._busy += 1
            task._begin()
        else:
            self.waits += 1
            self._queue.append(task)
            self.max_queued = max(self.max_queued, len(self._queue))

    def release(self, by: Optional["Task"] = None) -> None:
        self._busy -= 1
        if self._queue:
            self._busy += 1
            nxt = self._queue.popleft()
            nxt.granted_by = by
            nxt._begin()

    @property
    def busy_cycles(self) -> float:
        return sum(e - s for _, s, e, _ in self.spans)

    def utilization(self, t0: float = 0.0,
                    t1: Optional[float] = None) -> float:
        """Busy fraction of the window [t0, t1] (t1 defaults to the last
        span end). Spans never overlap on one resource, so a plain clipped
        sum is exact. A pipelined run's bottleneck resource approaches 1.0
        while the serial execution model leaves every stage mostly idle."""
        if t1 is None:
            t1 = max((e for _, _, e, _ in self.spans), default=0.0)
        if t1 <= t0:
            return 0.0
        busy = sum(min(e, t1) - max(s, t0)
                   for _, s, e, _ in self.spans if e > t0 and s < t1)
        return busy / (t1 - t0)


class Task:
    """One activity of the DAG. Build via :meth:`TaskGraph.task`."""

    __slots__ = ("graph", "name", "duration", "resource", "delay", "bytes",
                 "pid", "tid", "cat", "args", "start", "end", "requested_at",
                 "cause", "granted_by", "_npreds", "_succs", "record",
                 "_sim", "_emit")

    def __init__(self, graph: "TaskGraph", name: str, *, duration: float = 0.0,
                 resource: Optional[Resource] = None, delay: float = 0.0,
                 bytes: int = 0, pid: Optional[str] = None,
                 tid: Optional[str] = None, cat: Optional[str] = None,
                 record: bool = True, args: Optional[dict] = None) -> None:
        if duration < 0:
            raise ValueError(f"{name}: negative duration {duration}")
        self.graph = graph
        self._sim = graph.sim
        #: Whether _finish emits a trace span — resolved once per run by
        #: :meth:`TaskGraph.run` so the inner loop skips the trace-handle
        #: and duration checks per task.
        self._emit = False
        self.name = name
        self.duration = duration
        self.resource = resource
        self.delay = delay
        self.bytes = bytes
        self.pid = pid if pid is not None else (resource.pid if resource else "")
        self.tid = tid if tid is not None else (resource.tid if resource else "")
        self.cat = cat
        self.args = args or {}
        self.record = record
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        self.requested_at: Optional[float] = None
        #: The last-finishing predecessor — the dependency edge that
        #: released this task (None for DAG roots).
        self.cause: Optional["Task"] = None
        #: The task whose resource release promoted this one out of the
        #: FIFO wait queue (None when the grant was immediate).
        self.granted_by: Optional["Task"] = None
        self._npreds = 0
        self._succs: List["Task"] = []

    @property
    def done(self) -> bool:
        return self.end is not None

    def after(self, *preds: "Task") -> "Task":
        for p in preds:
            p._succs.append(self)
            self._npreds += 1
        return self

    # -- engine callbacks ---------------------------------------------------
    def _pred_done(self, pred: Optional["Task"] = None) -> None:
        self._npreds -= 1
        if self._npreds == 0:
            self.cause = pred
            self._sim.schedule(self.delay, self._request)

    def _request(self) -> None:
        self.requested_at = self._sim.now
        if self.resource is not None:
            self.resource.request(self)
        else:
            self._begin()

    def _begin(self) -> None:
        sim = self._sim
        self.start = sim.now
        if self.resource is not None and self.requested_at is not None:
            self.resource.wait_cycles += sim.now - self.requested_at
        sim.schedule(self.duration, self._finish)

    def _finish(self) -> None:
        self.end = self._sim.now
        if self.resource is not None:
            self.resource.spans.append((self.name, self.start, self.end,
                                        self.bytes))
            self.resource.release(self)
        if self._emit:
            self.graph.trace.span(self.pid, self.tid, self.name, self.start,
                                  self.end - self.start, cat=self.cat,
                                  args={**self.args, "bytes": self.bytes}
                                  if self.bytes else dict(self.args))
        for s in self._succs:
            s._pred_done(self)


class TaskGraph:
    """A static DAG of tasks over one simulator clock."""

    def __init__(self, sim: Optional[Simulator] = None, trace=None) -> None:
        self.sim = sim or Simulator()
        self.trace = trace
        self.tasks: List[Task] = []

    def task(self, name: str, **kw) -> Task:
        t = Task(self, name, **kw)
        self.tasks.append(t)
        return t

    def unfinished(self) -> List[Task]:
        return [t for t in self.tasks if not t.done]

    def run(self, *, max_events: int = 5_000_000) -> Simulator:
        tracing = self.trace is not None
        for t in self.tasks:
            t._emit = tracing and t.record and t.duration > 0
            if t._npreds == 0:
                self.sim.schedule(t.delay, t._request)
        self.sim.run(max_events=max_events)
        pending = self.unfinished()
        if pending:
            raise DeadlockError(pending)
        return self.sim

    @property
    def makespan(self) -> float:
        return max((t.end for t in self.tasks if t.end is not None),
                   default=0.0)
