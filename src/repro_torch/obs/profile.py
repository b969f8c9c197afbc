"""Critical-path latency attribution over the recorded Tier-S causality DAG.

The paper's diagnostic claim is that overheads like synchronization and
VLIW prologue are "often overlooked, making it infeasible to optimize
accelerators correctly". This module makes them un-overlookable: a
finished :class:`repro_torch.sim.run.SimResult` carries, per task, the causal
predecessor that released it (``Task.cause``), the resource holder whose
release granted it (``Task.granted_by``) and the Eq. (1)-(6) blame
decomposition of its duration (``args["blame"]`` / ``args["delay_blame"]``,
attached by :mod:`repro_torch.sim.run`). Walking backwards from each event's
completion therefore yields the *exact* per-event critical path, and every
cycle of the measured sojourn lands in one category of the paper's
overhead taxonomy:

  * the analytic categories of
    :data:`repro_torch.core.perfmodel.BLAME_CATEGORIES` — shim ingest/egress,
    tile compute, VLIW prologue, lock/sync, local store, cascade / DMA /
    shared-memory communication (signed: the fitted ``agg_fixed`` constant
    is negative, so aggregation layers can carry negative ``prologue``);
  * the emergent wait categories that only the simulator can see —
    ``queue_wait`` (FIFO wait behind the *same* instance, e.g. pipelined
    earlier events), ``xtenant:<label>`` (blocked by a co-resident
    instance ``<label>`` = ``tenant#replica`` on a shared shim column or
    tile), and ``admission_wait`` (open-loop time between the intended
    arrival and admission).

Conservation is checked, not assumed: per event, the blame segments sum to
the measured sojourn (:meth:`RunProfile.check`), and on a single-event run
the critical-path length equals the task graph's makespan.

The same recorded DAG powers the causal what-if engine: :func:`whatif`
scales one category's cycles on every task annotation and *replays* the
schedule — waits re-emerge from the replayed resource contention, so the
projection is Amdahl on the true DAG, not on aggregate shares.
``whatif(category, 1.0)`` reconstructs the original schedule exactly (the
scaling short-circuits to the recorded durations), and scaling a category
with parameter knobs (:data:`repro_torch.core.perfmodel.BLAME_PARAM_KNOBS`)
is validated against an actual re-simulation under
``perfmodel.scale_overheads`` in ``benchmarks/sim_vs_model.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import aie_arch
from repro_torch.core.perfmodel import BLAME_CATEGORIES

__all__ = [
    "BlameSegment", "EventProfile", "RunProfile", "WhatIfProjection",
    "profile_run", "whatif", "top_levers", "feed_blame_drift",
    "add_flow_events", "is_wait_category",
]

#: Numerical slack for classifying a chunk as non-empty (cycles).
_EPS = 1e-12


def is_wait_category(cat: str) -> bool:
    """True for the Tier-S-only emergent categories (no analytic twin)."""
    return (cat in ("queue_wait", "admission_wait")
            or cat.startswith("xtenant:"))


@dataclasses.dataclass(frozen=True)
class BlameSegment:
    """One attributed slice of an event's critical path.

    ``kind`` records which lifecycle chunk of the owning task the cycles
    came from: ``busy`` (resource-held duration), ``wait`` (FIFO queueing
    between request and grant), ``delay`` (scheduled launch skew, e.g. the
    cascade FIFO fill), or ``admission`` (open-loop gate wait before the
    event's root).
    """

    category: str
    cycles: float
    task: str
    kind: str


def _fit(parts: Optional[Dict[str, float]], length: float,
         default: str) -> List[Tuple[str, float]]:
    """Split a measured chunk per its annotation, conserving the total.

    The annotation is analytic (terms multiplied out separately), the
    chunk is measured — they agree up to float association, so the
    sub-ulp residual is folded into the largest-magnitude part.
    """
    if not parts:
        return [(default, length)] if length != 0.0 else []
    items = [(c, float(v)) for c, v in parts.items() if v != 0.0]
    if not items:
        return [(default, length)] if length != 0.0 else []
    resid = length - math.fsum(v for _, v in items)
    if resid:
        k = max(range(len(items)), key=lambda i: abs(items[i][1]))
        items[k] = (items[k][0], items[k][1] + resid)
    return items


@dataclasses.dataclass
class EventProfile:
    """The exact critical path of one event, fully attributed."""

    label: str                      #: owning instance (``tenant#replica``)
    tenant: str
    event: int
    sojourn_cycles: float           #: intended-arrival (or root) to done
    latency_cycles: float           #: root to done (dataflow + queueing)
    segments: List[BlameSegment]
    #: Critical-path tasks, completion-to-root order (for flow export).
    path_tasks: List[object] = dataclasses.field(default_factory=list,
                                                 repr=False)

    def blame(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.segments:
            out[s.category] = out.get(s.category, 0.0) + s.cycles
        return out

    @property
    def critical_path_cycles(self) -> float:
        return math.fsum(s.cycles for s in self.segments)

    def conservation_error(self) -> float:
        """|sum of blame - measured sojourn| in cycles (should be ~ulps)."""
        return abs(self.critical_path_cycles - self.sojourn_cycles)


def _walk_event(rec: Dict[str, object], inst, origin: float,
                event: int) -> EventProfile:
    """Walk ``Task.cause`` backwards from ``done`` to the event root.

    Per task three chunks telescope exactly to ``end - cause.end``:
    busy (``end - start``), FIFO wait (``start - requested_at``) and
    scheduled delay (``requested_at - cause.end``); summed down the chain
    they telescope to ``done.end - root.end``, so conservation against the
    measured sojourn holds to float precision by construction.
    """
    done, root = rec["done"], rec["root"]
    segments: List[BlameSegment] = []
    path: List[object] = []
    t = done
    while t is not None and t is not root:
        path.append(t)
        busy = t.end - t.start
        for cat, cyc in _fit(t.args.get("blame"), busy, "compute"):
            segments.append(BlameSegment(cat, cyc, t.name, "busy"))
        wait = t.start - t.requested_at
        if wait > _EPS:
            g = t.granted_by
            glabel = g.args.get("label") if g is not None else None
            if g is None or glabel == inst.label:
                cat = "queue_wait"
            else:
                cat = f"xtenant:{glabel or g.name}"
            segments.append(BlameSegment(cat, wait, t.name, "wait"))
        cause = t.cause
        base = cause.end if cause is not None else root.end
        delay = t.requested_at - base
        if delay > _EPS:
            for cat, cyc in _fit(t.args.get("delay_blame"), delay,
                                 "queue_wait"):
                segments.append(BlameSegment(cat, cyc, t.name, "delay"))
        t = cause
    admission = root.end - origin
    if admission > _EPS:
        segments.append(BlameSegment("admission_wait", admission,
                                     root.name, "admission"))
    return EventProfile(label=inst.label, tenant=inst.tenant, event=event,
                        sojourn_cycles=done.end - origin,
                        latency_cycles=done.end - root.end,
                        segments=segments, path_tasks=path)


@dataclasses.dataclass
class RunProfile:
    """Per-event critical-path profiles of one finished Tier-S run."""

    result: object                  #: the profiled repro_torch.sim.run.SimResult
    events: List[EventProfile]

    # -- aggregation ---------------------------------------------------------
    def blame_cycles(self, label: Optional[str] = None) -> Dict[str, float]:
        """Summed blame per category (one instance, or the whole run)."""
        out: Dict[str, float] = {}
        for ep in self.events:
            if label is not None and ep.label != label:
                continue
            for cat, cyc in ep.blame().items():
                out[cat] = out.get(cat, 0.0) + cyc
        return out

    def blame_shares(self, label: Optional[str] = None) -> Dict[str, float]:
        """Blame normalized to fractions of the summed (signed) total."""
        cyc = self.blame_cycles(label)
        total = sum(cyc.values())
        if not total:
            return {k: 0.0 for k in cyc}
        return {k: v / total for k, v in cyc.items()}

    def analytic_shares(self, label: Optional[str] = None) -> Dict[str, float]:
        """Shares over the analytic categories only (waits excluded) —
        the Tier-S side of the ``model.blame.*`` drift comparison."""
        cyc = self.blame_cycles(label)
        analytic = {c: cyc.get(c, 0.0) for c in BLAME_CATEGORIES}
        total = sum(analytic.values())
        if not total:
            return {k: 0.0 for k in analytic}
        return {k: v / total for k, v in analytic.items()}

    # -- verification --------------------------------------------------------
    def check(self, *, rel_tol: float = 1e-9,
              abs_tol: float = 1e-6) -> List[str]:
        """Conservation violations (empty = every event conserves)."""
        errs: List[str] = []
        for ep in self.events:
            if not math.isclose(ep.critical_path_cycles, ep.sojourn_cycles,
                                rel_tol=rel_tol, abs_tol=abs_tol):
                errs.append(
                    f"{ep.label}.e{ep.event}: blame sum "
                    f"{ep.critical_path_cycles!r} != sojourn "
                    f"{ep.sojourn_cycles!r}")
        return errs

    # -- rendering -----------------------------------------------------------
    def table(self, label: Optional[str] = None) -> str:
        """Human-readable blame table (category, cycles, ns, share)."""
        cyc = self.blame_cycles(label)
        total = sum(cyc.values())
        lines = [f"{'category':<22}{'cycles':>12}{'ns':>10}{'share':>9}"]
        for cat, v in sorted(cyc.items(), key=lambda kv: -abs(kv[1])):
            share = v / total if total else 0.0
            lines.append(f"{cat:<22}{v:>12.1f}{aie_arch.ns(v):>10.1f}"
                         f"{100 * share:>8.1f}%")
        lines.append(f"{'total':<22}{total:>12.1f}"
                     f"{aie_arch.ns(total):>10.1f}{'100.0%':>9}")
        return "\n".join(lines)

    def folded(self) -> str:
        """Folded-stack flamegraph lines: ``label;stage;category cycles``.

        Feed to any FlameGraph renderer (``flamegraph.pl``, speedscope,
        inferno). Stacks aggregate across events; counts are cycles
        rounded to integers (sub-cycle and negative components dropped —
        flame renderers require non-negative integer counts, so this is a
        visualization of the positive blame, not the signed ledger).
        """
        agg: Dict[Tuple[str, str, str], float] = {}
        for ep in self.events:
            evpfx = f"{ep.label}.e{ep.event}"
            for s in ep.segments:
                stage = s.task
                if stage.startswith(evpfx + "."):
                    stage = stage[len(evpfx) + 1:]
                key = (ep.label, stage, s.category)
                agg[key] = agg.get(key, 0.0) + s.cycles
        lines = []
        for (label, stage, cat), cyc in sorted(agg.items()):
            n = int(round(cyc))
            if n > 0:
                lines.append(f"{label};{stage};{cat} {n}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        per_event = [{
            "label": ep.label, "event": ep.event,
            "sojourn_cycles": ep.sojourn_cycles,
            "latency_cycles": ep.latency_cycles,
            "critical_path_cycles": ep.critical_path_cycles,
            "blame_cycles": ep.blame(),
        } for ep in self.events]
        return {"blame_cycles": self.blame_cycles(),
                "blame_shares": self.blame_shares(),
                "analytic_shares": self.analytic_shares(),
                "per_event": per_event,
                "conservation_errors": self.check()}

    def export_metrics(self, registry=None):
        """Emit ``profile.blame.{cycles,share}{instance, category}`` gauges
        into a :class:`repro_torch.obs.MetricsRegistry` (fresh one when None)."""
        from repro_torch.obs import MetricsRegistry
        reg = registry if registry is not None else MetricsRegistry()
        for inst in self.result.instances:
            cyc = self.blame_cycles(inst.label)
            total = sum(cyc.values())
            for cat, v in cyc.items():
                labels = {"instance": inst.label, "category": cat}
                reg.gauge("profile.blame.cycles", labels).set(v)
                reg.gauge("profile.blame.share", labels).set(
                    v / total if total else 0.0)
        return reg


def profile_run(result) -> RunProfile:
    """Extract every event's critical path from a finished Tier-S run."""
    events: List[EventProfile] = []
    for inst in result.instances:
        for e, rec in enumerate(inst.event_tasks):
            origin = (inst.arrivals[e] if inst.arrivals
                      else rec["root"].end)
            events.append(_walk_event(rec, inst, origin, e))
    return RunProfile(result=result, events=events)


# ---------------------------------------------------------------------------
# Causal what-if engine: scale one category, replay the recorded DAG
# ---------------------------------------------------------------------------

def _scaled(value: float, parts: Optional[Dict[str, float]],
            scale: Dict[str, float]) -> float:
    """Scale a duration/delay per its blame annotation.

    Short-circuits to the recorded value when no applicable factor differs
    from 1, so a factor-1.0 what-if replays the original schedule
    bit-exactly.
    """
    if not parts or all(scale.get(c, 1.0) == 1.0 for c in parts):
        return value
    scaled = math.fsum(float(v) * scale.get(c, 1.0)
                       for c, v in parts.items())
    resid = value - math.fsum(float(v) for v in parts.values())
    return max(0.0, scaled + resid)


def _replay(graph, scale: Dict[str, float]):
    """Re-execute the recorded DAG with scaled annotations.

    Rebuilds tasks in the original creation order and successor edges in
    the original notification order, so with all factors at 1 the replayed
    schedule — including every FIFO grant decision — is identical to the
    recorded one. Resource waits are *not* copied: they re-emerge from the
    replayed contention, which is what makes the projection Amdahl on the
    true DAG rather than on aggregate shares.
    """
    from repro_torch.sim.events import Resource, TaskGraph
    g2 = TaskGraph()
    rmap: Dict[int, Resource] = {}
    tmap: Dict[int, object] = {}
    for t in graph.tasks:
        r2 = None
        if t.resource is not None:
            r2 = rmap.get(id(t.resource))
            if r2 is None:
                r2 = rmap[id(t.resource)] = Resource(
                    t.resource.name, capacity=t.resource.capacity,
                    pid=t.resource.pid, tid=t.resource.tid)
        tmap[id(t)] = g2.task(
            t.name, duration=_scaled(t.duration, t.args.get("blame"), scale),
            resource=r2,
            delay=_scaled(t.delay, t.args.get("delay_blame"), scale),
            bytes=t.bytes, record=False)
    for t in graph.tasks:
        for s in t._succs:
            tmap[id(s)].after(tmap[id(t)])
    g2.run()
    return g2, tmap


def annotated_categories(result) -> List[str]:
    """Blame categories actually present in the run's task annotations —
    the levers :func:`whatif` can scale (waits are emergent, not levers)."""
    cats = set()
    for t in result.graph.tasks:
        for key in ("blame", "delay_blame"):
            d = t.args.get(key)
            if d:
                cats.update(d)
    return sorted(cats)


@dataclasses.dataclass(frozen=True)
class WhatIfProjection:
    """Projected effect of scaling one blame category by ``factor``."""

    category: str
    factor: float
    base_sojourn_cycles: float       #: mean over all events/instances
    projected_sojourn_cycles: float
    base_makespan_cycles: float
    projected_makespan_cycles: float

    @property
    def speedup(self) -> float:
        """Mean-sojourn speedup (>1 = the what-if helps)."""
        if self.projected_sojourn_cycles <= 0:
            return float("inf")
        return self.base_sojourn_cycles / self.projected_sojourn_cycles

    @property
    def makespan_speedup(self) -> float:
        if self.projected_makespan_cycles <= 0:
            return float("inf")
        return self.base_makespan_cycles / self.projected_makespan_cycles

    def as_dict(self) -> dict:
        return {"category": self.category, "factor": self.factor,
                "base_sojourn_cycles": self.base_sojourn_cycles,
                "projected_sojourn_cycles": self.projected_sojourn_cycles,
                "speedup": self.speedup,
                "makespan_speedup": self.makespan_speedup}


def whatif(result, category: str, factor: float) -> WhatIfProjection:
    """Project the run with one blame category scaled by ``factor``.

    Virtually multiplies every task annotation's ``category`` cycles by
    ``factor`` and replays the recorded schedule — an answer to "what if
    cascade sync were twice as fast" that honors the true DAG: shortening
    a category off the critical path buys nothing, and queueing re-forms
    behind whatever resource then binds.
    """
    cats = annotated_categories(result)
    if category not in cats:
        raise ValueError(f"category {category!r} not present in this run "
                         f"(levers: {cats})")
    if factor < 0:
        raise ValueError(f"factor must be >= 0, got {factor}")
    g2, tmap = _replay(result.graph, {category: factor})
    base: List[float] = []
    proj: List[float] = []
    for inst in result.instances:
        for e, rec in enumerate(inst.event_tasks):
            origin = (inst.arrivals[e] if inst.arrivals
                      else rec["root"].end)
            base.append(rec["done"].end - origin)
            origin2 = (inst.arrivals[e] if inst.arrivals
                       else tmap[id(rec["root"])].end)
            proj.append(tmap[id(rec["done"])].end - origin2)
    return WhatIfProjection(
        category=category, factor=factor,
        base_sojourn_cycles=sum(base) / len(base),
        projected_sojourn_cycles=sum(proj) / len(proj),
        base_makespan_cycles=result.graph.makespan,
        projected_makespan_cycles=g2.makespan)


def top_levers(result, *, factor: float = 0.5,
               categories: Optional[Sequence[str]] = None
               ) -> List[WhatIfProjection]:
    """Rank blame categories by projected speedup at the given factor.

    The ranked "top levers" table: each annotated category is scaled by
    ``factor`` (default: halved) and the run replayed; sorting by speedup
    surfaces the lever actually worth pulling — which aggregate shares
    alone cannot, because a large share off the critical path is a dead
    lever.
    """
    cats = list(categories) if categories else annotated_categories(result)
    projections = [whatif(result, c, factor) for c in cats]
    return sorted(projections, key=lambda w: -w.speedup)


# ---------------------------------------------------------------------------
# Tier-A vs Tier-S agreement (the model.blame.* drift family)
# ---------------------------------------------------------------------------

def feed_blame_drift(monitor, key: str, tier_a_cycles: Dict[str, float],
                     tier_s_cycles: Dict[str, float]) -> None:
    """Register ``model.blame.<category>`` drift entries for one design.

    Expect = the Tier-A analytic share (:func:`repro_torch.core.perfmodel.
    latency_blame`), observe = the Tier-S measured share. Both sides are
    normalized over the *analytic* categories only — emergent Tier-S waits
    (``queue_wait``, ``xtenant:*``, ``admission_wait``) have no analytic
    twin and are reported separately, never folded into this gate.
    Categories empty on both sides are skipped;
    ``monitor.family_mape("model.blame.")`` is the CI-gated aggregate.
    """
    ta_total = math.fsum(tier_a_cycles.get(c, 0.0) for c in BLAME_CATEGORIES)
    ts_total = math.fsum(tier_s_cycles.get(c, 0.0) for c in BLAME_CATEGORIES)
    for c in BLAME_CATEGORIES:
        a = tier_a_cycles.get(c, 0.0) / ta_total if ta_total else 0.0
        s = tier_s_cycles.get(c, 0.0) / ts_total if ts_total else 0.0
        if abs(a) < 1e-12 and abs(s) < 1e-12:
            continue
        metric = f"model.blame.{c}"
        monitor.expect(key, metric, a)
        monitor.observe(key, metric, s)


# ---------------------------------------------------------------------------
# Chrome-trace flow events: render the causal edges over the task spans
# ---------------------------------------------------------------------------

def add_flow_events(profile: RunProfile, trace=None,
                    name: str = "critical-path") -> int:
    """Draw each event's critical path as Chrome-trace flow arrows.

    Emits an ``s``/``f`` flow pair per causal edge, bound to the recorded
    task spans (start at the cause's completion, finish at the released
    task's start), so Perfetto renders the exact chain the blame profile
    walked. Returns the number of flow events added.
    """
    trace = trace if trace is not None else profile.result.trace
    if trace is None:
        return 0
    fid = 0
    added = 0
    for ep in profile.events:
        chain = [t for t in reversed(ep.path_tasks)
                 if t.record and t.duration > 0]
        for cause, released in zip(chain, chain[1:]):
            fid += 1
            trace.flow(cause.pid, cause.tid, name, cause.end,
                       id=fid, phase="s")
            trace.flow(released.pid, released.tid, name, released.start,
                       id=fid, phase="f")
            added += 2
    return added
