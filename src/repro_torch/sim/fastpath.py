"""Tier-S fast path: compiled static-schedule replay, bit-exact with the DES.

A placed workload's task DAG is *static*: every event of an instance runs
the same template of tasks (ingest slices, cascade-skewed layer spans,
inter-layer edges, egress) with the same durations, and the resources are
capacity-1 FIFO servers. The general DES re-derives all of that per event
— it calls the perfmodel occupancy/blame helpers and allocates a
:class:`~repro_torch.sim.events.Task` object for every task of every event, then
pays a heap operation per lifecycle step. This module compiles the graph
**once** into struct-of-arrays form (per-template duration / launch-delay /
resource-id / predecessor-index lists, plus per-event arrival offsets) and
replays completion times with one of two engines:

``sweep``
    A per-resource Lindley-style recursion in topological (template)
    order: ``ready = max(pred ends) + delay``, ``start = max(ready,
    resource last end)``, ``end = start + duration``. Valid whenever FIFO
    grant order is statically known: no resource shared between
    instances, and — when events overlap (``pipeline_depth > 1``) — no
    resource reused across template positions (see
    :attr:`CompiledRun.sweep_eligible`). This is the DSE-rescore /
    calibration hot path (``events=1``, single tenant, depth 1).

``heap``
    A lean indexed event loop over ``(time, seq, index, kind)`` tuples —
    an exact transcription of the DES algorithm (same event set, same
    schedule-order tie-breaking, same float additions) minus all Task
    object, blame-annotation, and trace machinery. Used for contended
    multi-tenant packings (shared shim columns), where grant order is
    dynamic.

**Bit-exactness.** Both engines perform *literally the same float
operations in the same order* as the DES: every timestamp is either a
``prior + delay``/``prior + duration`` sum or a max/selection over
existing timestamps, so completion, sojourn, and stage-occupancy cycles
compare with ``==``, not approximately — the parity suites in
``tests/test_sim_fastpath.py``, ``tests/test_sim_properties.py`` and
``benchmarks/sim_fastpath.py`` assert exactly that.

**Fallback rules** (:func:`supports`): the fast path keeps no task graph,
resource spans, or Chrome trace, so any feature that needs them runs on
the DES — ``config.trace=True`` or an external tracer (span recording),
per-task blame/profiling (:mod:`repro_torch.obs.profile` walks ``Task.cause``),
and :func:`repro_torch.sim.run.invariant_errors` (needs spans). ``engine="auto"``
falls back silently (counted in :data:`COUNTERS`), ``engine="fast"``
raises :class:`FastpathUnsupported`. A replay that stalls (impossible for
graphs this module compiles, which are DAGs by construction) re-runs the
DES so the caller still gets its diagnostic
:class:`~repro_torch.sim.events.DeadlockError`.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import aie_arch, perfmodel
from repro_torch.core.aie_arch import OverheadParams, OVERHEADS
from repro_torch.core.placement import Placement
from repro_torch.core.tenancy import shim_transfer_cycles

from .run import InstanceStats, ResultStats, SimConfig


class FastpathUnsupported(RuntimeError):
    """The requested features need the full DES (see :func:`supports`)."""


#: Module-level fast-path telemetry: replay counts per engine and fallback
#: counts per reason (exported as the ``sim.fastpath.*`` metric family).
COUNTERS: Dict[str, Dict[str, int]] = {"replays": {}, "fallbacks": {}}


def record_fallback(reason: str) -> None:
    COUNTERS["fallbacks"][reason] = COUNTERS["fallbacks"].get(reason, 0) + 1


def export_counters(registry=None):
    """Emit :data:`COUNTERS` into a :class:`repro_torch.obs.MetricsRegistry`."""
    from repro_torch.obs import MetricsRegistry
    reg = registry if registry is not None else MetricsRegistry()
    for engine, n in COUNTERS["replays"].items():
        reg.counter("sim.fastpath.replays", {"engine": engine}).inc(n)
    for reason, n in COUNTERS["fallbacks"].items():
        reg.counter("sim.fastpath.fallbacks", {"reason": reason}).inc(n)
    return reg


def supports(config: SimConfig, *, tracer=None) -> Optional[str]:
    """Why this run needs the DES — ``None`` when the fast path applies."""
    if tracer is not None:
        return "external tracer attached (span recording needs the DES)"
    if config.trace:
        return "chrome-trace recording requested (spans need the DES)"
    return None


# ---------------------------------------------------------------------------
# Compilation: placement/schedule -> struct-of-arrays template per instance
# ---------------------------------------------------------------------------

class _ResTable:
    """Integer resource ids with the same sharing semantics as
    :class:`repro_torch.sim.array.ArrayResources` (shim columns shared across
    co-resident tenants when ``shim_shared``, private otherwise)."""

    def __init__(self, shim_shared: bool) -> None:
        self.shim_shared = shim_shared
        self._ids: Dict[tuple, int] = {}
        self._users: List[int] = []   # first instance index per resource
        self.shared = False           # any resource used by >= 2 instances

    def _get(self, key: tuple, inst: int) -> int:
        i = self._ids.get(key)
        if i is None:
            i = self._ids[key] = len(self._users)
            self._users.append(inst)
        elif self._users[i] != inst:
            self.shared = True
        return i

    def tile(self, r: int, c: int, inst: int) -> int:
        return self._get(("tile", r, c), inst)

    def shim(self, col: int, owner: str, inst: int) -> int:
        key = ("shim", col) if self.shim_shared else ("shim", owner, col)
        return self._get(key, inst)

    def edge(self, name: str, inst: int) -> int:
        return self._get(("edge", name), inst)

    @property
    def n(self) -> int:
        return len(self._users)


@dataclasses.dataclass
class CompiledInstance:
    """One instance's event template plus its per-event variations."""

    label: str
    tenant: str
    replica: int
    placement: Placement
    n_events: int
    # Template arrays, one entry per task of one event, in the exact task
    # creation order of repro_torch.sim.run._build_instance:
    t_dur: List[float]
    t_delay: List[float]
    t_res: List[int]                      # -1 = no resource
    t_preds: List[Tuple[int, ...]]        # template-local indices
    t_occ: List[Optional[tuple]]          # stage-occupancy bucket or None
    root_idx: int
    done_idx: int
    offered_idx: int                      # -1 when closed loop
    # Per-event launch-delay overrides (None = template delay everywhere):
    var_offered: Optional[List[float]]    # open-loop intended arrivals
    var_root: Optional[List[float]]       # closed-loop jitter draws
    edge_kinds: List[str]                 # stage-dict keys, in layer order

    @property
    def n_tasks(self) -> int:
        return len(self.t_dur) * self.n_events

    @property
    def intra_repeat(self) -> bool:
        """True when some resource serves more than one template position
        (e.g. a shim column used by both ingest and egress)."""
        used = [r for r in self.t_res if r >= 0]
        return len(used) != len(set(used))

    def t_succs(self) -> List[List[int]]:
        succs: List[List[int]] = [[] for _ in self.t_dur]
        for t, ps in enumerate(self.t_preds):
            for q in ps:
                succs[q].append(t)
        return succs


@dataclasses.dataclass
class CompiledRun:
    """A whole run compiled: templates + resource table + replay choice."""

    instances: List[CompiledInstance]
    res: _ResTable
    cfg: SimConfig
    p: OverheadParams
    source: tuple                 # ("placement", pl, tenant) | ("schedule", s)
    compile_s: float

    @property
    def n_tasks(self) -> int:
        return sum(ci.n_tasks for ci in self.instances)

    @property
    def sweep_eligible(self) -> bool:
        """The static Lindley sweep is exact iff FIFO grant order at every
        resource is statically known — template order within an event,
        event order across events. Two conditions guarantee that:

        * No resource shared **between instances** — cross-tenant shim
          contention makes grant order depend on computed times.
        * Events in flight never overlap on a resource out of order.
          At ``pipeline_depth == 1`` serial admission totally orders
          events, so any intra-template reuse (a shim column serving
          both ingest and egress) is resolved by the dependency chain.
          At ``depth > 1`` (or open loop with ``depth > 1``) events
          overlap, so every resource must be pinned to a *single*
          template position: then the per-instance arrival chain
          (``root_e.after(root_{e-1})``) keeps each position's request
          series monotone in the event index and FIFO grants in event
          order. A resource reused across template positions (ingest
          vs. egress on one shim column) interleaves dynamically —
          event e+1's ingest may request before event e's egress — and
          needs the heap transcription.

        The parity suites assert ``==`` against the DES on both sides of
        this predicate."""
        if self.res.shared:
            return False
        depth = max(1, self.cfg.pipeline_depth)
        if depth == 1:
            return True
        return not any(ci.intra_repeat for ci in self.instances)


def _compile_instance(res: _ResTable, placement: Placement, *, tenant: str,
                      replica: int, inst_idx: int, n_events: int,
                      p: OverheadParams, cfg: SimConfig,
                      rng: random.Random) -> CompiledInstance:
    """Template twin of :func:`repro_torch.sim.run._build_instance`.

    Task creation order, dependency edges, durations, and launch delays
    mirror the DES builder exactly (the heap replay relies on creation
    order for schedule-order tie-breaking); the perfmodel occupancy and
    shim pricing are computed once instead of per event, and no blame
    annotations or Task objects are materialized — which is where the
    compile-time win over DES graph construction comes from.
    """
    label = f"{tenant}#{replica}"
    maps = placement.model_mapping.mappings
    links = placement.cascade_links()
    ecs = perfmodel.edge_comms(placement, p=p, ideal=cfg.ideal)
    cols, t_in, t_out = shim_transfer_cycles(
        placement, p=p, streams_per_col=cfg.shim_streams_per_col,
        ideal=cfg.ideal)

    var_offered: Optional[List[float]] = None
    var_root: Optional[List[float]] = None
    if cfg.open_loop:
        # Same lazy import and the same per-instance draw order off the
        # shared seeded RNG as the DES builder — identical floats.
        from repro_torch.serve import workload
        var_offered = list(workload.arrival_cycles(cfg.arrivals, n_events,
                                                   rng=rng))
    elif cfg.jitter_cycles > 0:
        var_root = [rng.uniform(0.0, cfg.jitter_cycles)
                    for _ in range(n_events)]

    t_dur: List[float] = []
    t_delay: List[float] = []
    t_res: List[int] = []
    t_preds: List[Tuple[int, ...]] = []
    t_occ: List[Optional[tuple]] = []

    def add(dur: float = 0.0, delay: float = 0.0, rid: int = -1,
            preds: Tuple[int, ...] = (), occ: Optional[tuple] = None) -> int:
        if dur < 0:
            raise ValueError(f"{label}: negative duration {dur}")
        t_dur.append(dur)
        t_delay.append(delay)
        t_res.append(rid)
        t_preds.append(preds)
        t_occ.append(occ)
        return len(t_dur) - 1

    offered_idx = -1
    if var_offered is not None:
        offered_idx = add()               # delay comes from var_offered[e]
        root_idx = add(preds=(offered_idx,))
    else:
        root_idx = add()                  # delay from var_root[e] if jittered
    cur = root_idx
    if cfg.include_plio:
        ingest = tuple(add(dur=t_in, rid=res.shim(c, label, inst_idx),
                           preds=(root_idx,), occ=("shim", c)) for c in cols)
        cur = add(preds=ingest)           # "loaded" barrier marker
    edge_kinds: List[str] = []
    for i, m in enumerate(maps):
        out_cas = i < len(links) and links[i]
        occ = perfmodel.layer_occupancy(m, out_cascade=out_cas, p=p,
                                        ideal=cfg.ideal)
        rect = placement.rects[i]
        stage = f"L{i}:{m.layer.name or m.layer.kind}"
        spans = tuple(
            add(dur=d, delay=s, rid=res.tile(rect.r0 + lr, rect.c0 + lc,
                                             inst_idx), preds=(cur,),
                occ=(stage, (rect.r0 + lr, rect.c0 + lc)))
            for lr, lc, s, d in occ.spans)
        ldone = add(preds=spans)
        if i == len(maps) - 1:
            cur = ldone
            continue
        ec = ecs[i]
        edge_kinds.append(ec.kind)
        cur = add(dur=ec.cycles,
                  rid=res.edge(f"{label}.L{i}>L{i + 1}", inst_idx),
                  preds=(ldone,), occ=(f"L{i}>L{i + 1}:{ec.kind}", None))
    if cfg.include_plio:
        egress = tuple(add(dur=t_out, rid=res.shim(c, label, inst_idx),
                           preds=(cur,), occ=("shim", c)) for c in cols)
        cur = add(preds=egress)           # "done" marker
    return CompiledInstance(
        label=label, tenant=tenant, replica=replica, placement=placement,
        n_events=n_events, t_dur=t_dur, t_delay=t_delay, t_res=t_res,
        t_preds=t_preds, t_occ=t_occ, root_idx=root_idx, done_idx=cur,
        offered_idx=offered_idx, var_offered=var_offered, var_root=var_root,
        edge_kinds=edge_kinds)


def compile_placement(placement: Placement, *, tenant: str = "model",
                      p: OverheadParams = OVERHEADS,
                      config: Optional[SimConfig] = None) -> CompiledRun:
    cfg = config or SimConfig(events=1, trace=False)
    t0 = time.perf_counter()
    res = _ResTable(cfg.shim_contention)
    rng = random.Random(cfg.seed)
    insts = [_compile_instance(res, placement, tenant=tenant, replica=0,
                               inst_idx=0, n_events=cfg.events, p=p, cfg=cfg,
                               rng=rng)]
    return CompiledRun(instances=insts, res=res, cfg=cfg, p=p,
                       source=("placement", placement, tenant),
                       compile_s=time.perf_counter() - t0)


def compile_schedule(schedule, *, p: OverheadParams = OVERHEADS,
                     config: Optional[SimConfig] = None) -> CompiledRun:
    cfg = config or SimConfig(events=1, trace=False)
    t0 = time.perf_counter()
    res = _ResTable(cfg.shim_contention)
    rng = random.Random(cfg.seed)
    insts = [_compile_instance(res, inst.placement, tenant=inst.tenant,
                               replica=inst.replica, inst_idx=k,
                               n_events=cfg.events, p=p, cfg=cfg, rng=rng)
             for k, inst in enumerate(schedule.instances)]
    return CompiledRun(instances=insts, res=res, cfg=cfg, p=p,
                       source=("schedule", schedule),
                       compile_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

class FastInstance(InstanceStats):
    """Per-instance completion streams measured by a fast replay.

    Quacks like :class:`repro_torch.sim.run.InstanceSim` for every derived
    statistic (latencies, steady intervals, sojourns) — the formulas live
    in the shared :class:`repro_torch.sim.run.InstanceStats` mixin.
    """

    def __init__(self, ci: CompiledInstance, root_cycles: List[float],
                 completion_cycles: List[float]) -> None:
        self.label = ci.label
        self.tenant = ci.tenant
        self.replica = ci.replica
        self.placement = ci.placement
        self.root_cycles = root_cycles
        self.completion_cycles = completion_cycles
        self.arrivals = list(ci.var_offered or [])
        self.edge_kinds = list(ci.edge_kinds)


class FastResult(ResultStats):
    """Replay measurements — the span-free counterpart of
    :class:`repro_torch.sim.run.SimResult`.

    Carries no task graph, resource spans, or trace (those are DES-only
    features, see :func:`supports`); everything stream-derived — latency,
    throughput, sojourn percentiles, steady intervals, and (when compiled
    with ``stages=True``) per-stage occupancy — is bit-exact with the DES.
    """

    def __init__(self, *, engine: str, instances: List[FastInstance],
                 config: SimConfig, makespan_cycles: float, events_run: int,
                 n_tasks: int, compile_s: float, replay_s: float,
                 stage_busy: Optional[List[Dict[tuple, float]]]) -> None:
        self.engine = engine
        self.instances = instances
        self.config = config
        self.makespan_cycles = makespan_cycles
        self.events_run = events_run
        self.n_tasks = n_tasks
        self.compile_s = compile_s
        self.replay_s = replay_s
        self._stage_busy = stage_busy

    @property
    def events_per_sec_engine(self) -> float:
        """Replay rate in engine events/sec (the speedup gate's unit)."""
        return self.events_run / self.replay_s if self.replay_s > 0 else 0.0

    def stage_occupancy_cycles(self, instance: int = 0) -> Dict[str, float]:
        """Bit-exact twin of :meth:`repro_torch.sim.run.SimResult.stage_occupancy_cycles`
        (same keys, same floats): per-bucket busy cycles are accumulated in
        completion order during the replay — the same order the DES appends
        resource spans — so the per-stage sums match exactly. Requires the
        replay to have run with ``stages=True``."""
        if self._stage_busy is None:
            raise FastpathUnsupported(
                "stage occupancy was not accumulated — replay with "
                "stages=True")
        inst = self.instances[instance]
        busy = self._stage_busy[instance]
        n_events = max(1, len(inst.completion_cycles))
        out: Dict[str, float] = {}
        if self.config.include_plio:
            out["shim"] = max(
                (v / n_events for k, v in busy.items() if k[0] == "shim"),
                default=0.0)
        maps = inst.placement.model_mapping.mappings
        for i, (m, rect) in enumerate(zip(maps, inst.placement.rects)):
            stage = f"L{i}:{m.layer.name or m.layer.kind}"
            busiest = 0.0
            for lr in range(m.rows):
                for lc in range(m.cols):
                    busiest = max(busiest,
                                  busy.get((stage, (rect.r0 + lr,
                                                    rect.c0 + lc)), 0.0)
                                  / n_events)
            out[stage] = busiest
        for i, kind in enumerate(inst.edge_kinds):
            key = f"L{i}>L{i + 1}:{kind}"
            out[key] = busy.get((key, None), 0.0) / n_events
        return out

    def export_metrics(self, registry=None):
        """Emit the replay's telemetry (``sim.fastpath.*`` plus the shared
        per-instance event statistics). Resource utilization/wait gauges
        are DES-only — the fast path keeps no spans."""
        from repro_torch.obs import MetricsRegistry
        reg = registry if registry is not None else MetricsRegistry()
        for inst in self.instances:
            h = reg.histogram("sim.event.latency_ns",
                              {"instance": inst.label})
            for lat in inst.latencies:
                h.record(aie_arch.ns(lat))
            reg.gauge("sim.instance.steady_interval_ns",
                      {"instance": inst.label}
                      ).set(aie_arch.ns(inst.steady_interval_cycles()))
            reg.counter("sim.events.completed",
                        {"instance": inst.label}).inc(len(inst.latencies))
            if inst.arrivals:
                hs = reg.histogram("sim.event.sojourn_ns",
                                   {"instance": inst.label})
                hw = reg.histogram("sim.event.queue_wait_ns",
                                   {"instance": inst.label})
                for s, w in zip(inst.sojourn_cycles,
                                inst.queue_wait_cycles()):
                    hs.record(aie_arch.ns(s))
                    hw.record(aie_arch.ns(w))
                reg.gauge("sim.instance.offered_eps",
                          {"instance": inst.label}).set(inst.offered_eps)
        reg.gauge("sim.engine.events_run").set(self.events_run)
        reg.gauge("sim.makespan_ns").set(aie_arch.ns(self.makespan_cycles))
        reg.gauge("sim.throughput.steady_eps").set(
            self.steady_throughput_eps())
        reg.gauge("sim.fastpath.compile_s").set(self.compile_s)
        reg.gauge("sim.fastpath.replay_s").set(self.replay_s)
        reg.gauge("sim.fastpath.events_per_sec").set(
            self.events_per_sec_engine)
        export_counters(reg)
        return reg


# ---------------------------------------------------------------------------
# Replay engines
# ---------------------------------------------------------------------------

def _replay_sweep(cr: CompiledRun, stages: bool):
    """Static per-resource Lindley sweep (no cross-instance sharing).

    Processes tasks in template order per event: dependencies only point
    backwards and — because the arrival chain keeps every per-event task
    time monotone in the event index — each resource grants its FIFO in
    event order, so a single forward pass reproduces the DES schedule.
    Float ops match the DES exactly: ``ready = max(pred ends) + delay``;
    ``start = max(ready, last end on the resource)``; ``end = start +
    duration``.
    """
    total = 2 * cr.n_tasks
    depth = max(1, cr.cfg.pipeline_depth)
    chain = depth > 1 or cr.cfg.open_loop
    res_last = [0.0] * cr.res.n
    makespan = 0.0
    out = []
    stage_busy: Optional[List[Dict[tuple, float]]] = [] if stages else None
    for ci in cr.instances:
        dur, delay, rids, preds = ci.t_dur, ci.t_delay, ci.t_res, ci.t_preds
        occ = ci.t_occ
        T = len(dur)
        root_i, done_i, off_i = ci.root_idx, ci.done_idx, ci.offered_idx
        var_off, var_root = ci.var_offered, ci.var_root
        busy: Dict[tuple, float] = {}
        ends = [0.0] * T
        roots: List[float] = []
        dones: List[float] = []
        for e in range(ci.n_events):
            for t in range(T):
                ps = preds[t]
                if ps:
                    ready = ends[ps[0]]
                    for q in ps[1:]:
                        v = ends[q]
                        if v > ready:
                            ready = v
                else:
                    ready = 0.0
                if t == root_i:
                    # Cross-event admission edges of the arrive task:
                    # done(e-depth) bounds the number of events in
                    # flight, plus the arrival chain when pipelined or
                    # open-loop (matches _build_instance exactly).
                    if e >= depth:
                        v = dones[e - depth]
                        if v > ready:
                            ready = v
                    if chain and e > 0:
                        v = roots[e - 1]
                        if v > ready:
                            ready = v
                    d = var_root[e] if var_root is not None else delay[t]
                elif t == off_i:
                    d = var_off[e]
                else:
                    d = delay[t]
                ready = ready + d
                r = rids[t]
                if r >= 0:
                    last = res_last[r]
                    start = last if last > ready else ready
                    end = start + dur[t]
                    res_last[r] = end
                    if stages:
                        k = occ[t]
                        busy[k] = busy.get(k, 0.0) + (end - start)
                else:
                    end = ready + dur[t]
                ends[t] = end
            roots.append(ends[root_i])
            dones.append(ends[done_i])
        if dones and dones[-1] > makespan:
            makespan = dones[-1]
        out.append((roots, dones))
        if stage_busy is not None:
            stage_busy.append(busy)
    return out, makespan, total, stage_busy


def _replay_heap(cr: CompiledRun, stages: bool):
    """Faithful lean transcription of the DES event loop.

    Flattens the templates into per-task arrays (instance-major,
    event-major — the DES task creation order), then runs the identical
    algorithm: REQUEST events acquire the FIFO resource or queue; FINISH
    events promote the queue head *before* notifying successors (matching
    ``Resource.release`` running inside ``Task._finish``); ties break by a
    monotonically increasing sequence number assigned in the same order
    the DES assigns its own. Bit-exact by construction.
    """
    cfg = cr.cfg
    depth = max(1, cfg.pipeline_depth)
    chain = depth > 1 or cfg.open_loop
    dur: List[float] = []
    delay: List[float] = []
    rids: List[int] = []
    npreds: List[int] = []
    bases: List[int] = []                 # each task's event base offset
    tsuccs: List[List[int]] = []          # template succ list, SHARED per
    #                                       event (relative to bases[f])
    occs: List[tuple] = []
    inst_meta = []   # (base, T, root_idx, done_idx, n_events, inst_idx)
    xsucc_keys: List[int] = []            # cross-event edges, sparse:
    xsucc_vals: List[int] = []            # source task -> absolute succ
    for k, ci in enumerate(cr.instances):
        T = len(ci.t_dur)
        t_np = [len(ps) for ps in ci.t_preds]
        t_sc = ci.t_succs()
        var_off, var_root = ci.var_offered, ci.var_root
        inst_base = len(dur)
        inst_meta.append((inst_base, T, ci.root_idx, ci.done_idx,
                          ci.n_events, k))
        for e in range(ci.n_events):
            base = len(dur)
            dur.extend(ci.t_dur)
            delay.extend(ci.t_delay)
            rids.extend(ci.t_res)
            npreds.extend(t_np)
            bases.extend([base] * T)
            tsuccs.extend(t_sc)
            if stages:
                occs.extend((k, o) for o in ci.t_occ)
            if var_off is not None:
                delay[base + ci.offered_idx] = var_off[e]
            if var_root is not None:
                delay[base + ci.root_idx] = var_root[e]
            root_f = base + ci.root_idx
            # Cross-event admission edges — notified after the template
            # successors exactly as _build_instance appends them (event
            # e's edges are created after event e-1 is fully built):
            if e >= depth:
                xsucc_keys.append(inst_base + (e - depth) * T + ci.done_idx)
                xsucc_vals.append(root_f)
                npreds[root_f] += 1
            if e > 0 and chain:
                xsucc_keys.append(inst_base + (e - 1) * T + ci.root_idx)
                xsucc_vals.append(root_f)
                npreds[root_f] += 1
    xsucc: List[Optional[List[int]]] = [None] * len(dur)
    for kf, vf in zip(xsucc_keys, xsucc_vals):
        lst = xsucc[kf]
        if lst is None:
            xsucc[kf] = [vf]
        else:
            lst.append(vf)
    n = len(dur)
    ends = [0.0] * n
    rbusy = bytearray(cr.res.n)
    rqueue: List[deque] = [deque() for _ in range(cr.res.n)]
    # Heap entries are (time, seq, code): code < n is task code's REQUEST,
    # code >= n is task (code - n)'s FINISH. seq is unique, so codes are
    # never compared and the pop order is exactly the DES's (time, seq).
    heap: List[Tuple[float, int, int]] = []
    push = heapq.heappush
    pop = heapq.heappop
    seq = 0
    for f in range(n):
        if npreds[f] == 0:
            seq += 1
            push(heap, (0.0 + delay[f], seq, f))
    maxe = cfg.max_events
    makespan = 0.0
    stage_busy: Optional[List[Dict[tuple, float]]] = (
        [{} for _ in cr.instances] if stages else None)
    if stages or 2 * n > maxe:
        # Faithful counting loop: tracks per-event budget (to raise the
        # DES's exact RuntimeError at the exact event time) and start
        # times (for stage-occupancy accumulation).
        starts = [0.0] * n
        events_run = 0
        while heap:
            t_, _, code = pop(heap)
            if code < n:                  # REQUEST: acquire or queue
                f = code
                r = rids[f]
                if r < 0:
                    starts[f] = t_
                    seq += 1
                    push(heap, (t_ + dur[f], seq, code + n))
                elif not rbusy[r]:
                    rbusy[r] = 1
                    starts[f] = t_
                    seq += 1
                    push(heap, (t_ + dur[f], seq, code + n))
                else:
                    rqueue[r].append(f)
            else:                         # FINISH: release, then notify
                f = code - n
                ends[f] = t_
                makespan = t_
                r = rids[f]
                if r >= 0:
                    if stages:
                        ik, key = occs[f]
                        b = stage_busy[ik]
                        b[key] = b.get(key, 0.0) + (t_ - starts[f])
                    q = rqueue[r]
                    if q:
                        nf = q.popleft()
                        starts[nf] = t_
                        seq += 1
                        push(heap, (t_ + dur[nf], seq, nf + n))
                    else:
                        rbusy[r] = 0
                b = bases[f]
                for s in tsuccs[f]:
                    sa = b + s
                    left = npreds[sa] - 1
                    npreds[sa] = left
                    if not left:
                        seq += 1
                        push(heap, (t_ + delay[sa], seq, sa))
                ex = xsucc[f]
                if ex is not None:
                    for sa in ex:
                        left = npreds[sa] - 1
                        npreds[sa] = left
                        if not left:
                            seq += 1
                            push(heap, (t_ + delay[sa], seq, sa))
            events_run += 1
            if events_run > maxe:
                raise RuntimeError(
                    f"event budget exceeded ({maxe}) at t={t_}")
    else:
        # Hot loop: the DES runs exactly one REQUEST + one FINISH per
        # task, so when 2n fits the budget no per-event accounting is
        # needed — and without stages, start times are never read.
        events_run = 2 * n
        while heap:
            t_, _, code = pop(heap)
            if code < n:                  # REQUEST: acquire or queue
                r = rids[code]
                if r < 0 or not rbusy[r]:
                    if r >= 0:
                        rbusy[r] = 1
                    seq += 1
                    push(heap, (t_ + dur[code], seq, code + n))
                else:
                    rqueue[r].append(code)
            else:                         # FINISH: release, then notify
                f = code - n
                ends[f] = t_
                makespan = t_
                r = rids[f]
                if r >= 0:
                    q = rqueue[r]
                    if q:
                        nf = q.popleft()
                        seq += 1
                        push(heap, (t_ + dur[nf], seq, nf + n))
                    else:
                        rbusy[r] = 0
                b = bases[f]
                for s in tsuccs[f]:
                    sa = b + s
                    left = npreds[sa] - 1
                    npreds[sa] = left
                    if not left:
                        seq += 1
                        push(heap, (t_ + delay[sa], seq, sa))
                ex = xsucc[f]
                if ex is not None:
                    for sa in ex:
                        left = npreds[sa] - 1
                        npreds[sa] = left
                        if not left:
                            seq += 1
                            push(heap, (t_ + delay[sa], seq, sa))
    if any(x > 0 for x in npreds) or any(rqueue):
        _diagnose_stall(cr, sum(1 for x in npreds if x > 0)
                        + sum(len(q) for q in rqueue))
    out = []
    for base, T, root_i, done_i, n_events, _ in inst_meta:
        roots = [ends[base + e * T + root_i] for e in range(n_events)]
        dones = [ends[base + e * T + done_i] for e in range(n_events)]
        out.append((roots, dones))
    return out, makespan, events_run, stage_busy


def _diagnose_stall(cr: CompiledRun, n_pending: int) -> None:
    """A compiled graph is a DAG by construction, so a stalled replay means
    either a genuine deadlock (which the DES diagnoses with task names) or
    a fast-path bug. Re-run the DES to find out — and refuse to return a
    fast result either way."""
    from . import run as simrun
    cfg = dataclasses.replace(cr.cfg, trace=False)
    if cr.source[0] == "placement":
        simrun.simulate_placement(cr.source[1], tenant=cr.source[2], p=cr.p,
                                  config=cfg)
    else:
        simrun.simulate_schedule(cr.source[1], p=cr.p, config=cfg)
    raise RuntimeError(
        f"fastpath replay stalled with {n_pending} task(s) pending but the "
        "DES completed the same run — engine bug, please report")


def replay(cr: CompiledRun, *, engine: Optional[str] = None,
           stages: bool = False) -> FastResult:
    """Replay a compiled run and package the measurement streams.

    ``engine`` forces ``"sweep"`` or ``"heap"``; by default the sweep is
    used whenever it is exact (see :attr:`CompiledRun.sweep_eligible`) and
    the heap transcription otherwise. ``stages=True`` additionally
    accumulates per-stage busy cycles for
    :meth:`FastResult.stage_occupancy_cycles`.
    """
    over_budget = 2 * cr.n_tasks > cr.cfg.max_events
    if engine is None:
        # A run that exceeds the event budget must raise the DES's exact
        # RuntimeError (same message, same event time); only the heap
        # transcription replays events in (time, seq) order and can.
        engine = ("sweep" if cr.sweep_eligible and not over_budget
                  else "heap")
    elif engine == "sweep":
        if not cr.sweep_eligible:
            raise FastpathUnsupported(
                "sweep engine is only exact when FIFO grant order is "
                "static (no cross-instance sharing; no intra-template "
                "resource reuse when pipelined)")
        if over_budget:
            raise FastpathUnsupported(
                "run exceeds max_events; the heap engine reproduces the "
                "DES budget diagnostic")
    t0 = time.perf_counter()
    if engine == "sweep":
        streams, makespan, events_run, stage_busy = _replay_sweep(cr, stages)
    elif engine == "heap":
        streams, makespan, events_run, stage_busy = _replay_heap(cr, stages)
    else:
        raise ValueError(f"unknown replay engine {engine!r}")
    replay_s = time.perf_counter() - t0
    COUNTERS["replays"][engine] = COUNTERS["replays"].get(engine, 0) + 1
    insts = [FastInstance(ci, roots, dones)
             for ci, (roots, dones) in zip(cr.instances, streams)]
    return FastResult(engine=engine, instances=insts, config=cr.cfg,
                      makespan_cycles=makespan, events_run=events_run,
                      n_tasks=cr.n_tasks, compile_s=cr.compile_s,
                      replay_s=replay_s, stage_busy=stage_busy)


def simulate_placement_fast(placement: Placement, *, tenant: str = "model",
                            p: OverheadParams = OVERHEADS,
                            config: Optional[SimConfig] = None,
                            stages: bool = False) -> FastResult:
    """Compile + replay one standalone instance (fast twin of
    :func:`repro_torch.sim.run.simulate_placement`). Raises
    :class:`FastpathUnsupported` when the config needs the DES."""
    cfg = config or SimConfig(events=1, trace=False)
    reason = supports(cfg)
    if reason is not None:
        raise FastpathUnsupported(reason)
    return replay(compile_placement(placement, tenant=tenant, p=p,
                                    config=cfg), stages=stages)


def simulate_schedule_fast(schedule, *, p: OverheadParams = OVERHEADS,
                           config: Optional[SimConfig] = None,
                           stages: bool = False) -> FastResult:
    """Compile + replay a multi-tenant schedule (fast twin of
    :func:`repro_torch.sim.run.simulate_schedule`)."""
    cfg = config or SimConfig(events=1, trace=False)
    reason = supports(cfg)
    if reason is not None:
        raise FastpathUnsupported(reason)
    return replay(compile_schedule(schedule, p=p, config=cfg), stages=stages)


# ---------------------------------------------------------------------------
# Batched rescoring for dse.search(rescore=...)
# ---------------------------------------------------------------------------

def _score_chunk(payload):
    """Process-pool worker: score one chunk of (tenant, placement) pairs."""
    p, cfg, items = payload
    from repro_torch.sim import run as simrun
    return [simrun.simulate_placement(pl, tenant=t, p=p, config=cfg,
                                      engine="auto").latency_cycles
            for t, pl in items]


class Rescorer:
    """Fast-path re-scoring hook with batch support for
    :func:`repro_torch.core.dse.search`.

    Plain-callable compatible with the legacy DES closure (design ->
    simulated cycles), plus :meth:`score_batch`, which ``dse.search``
    prefers when present: candidates are scored in ``chunk``-sized batches
    so per-call dispatch (and, with ``workers > 1``, process fan-out) is
    amortized across the whole top-K. Scores are bit-exact with the DES
    regardless of chunking, worker count, or fallback — the rescored
    ranking cannot depend on how the batch was split.
    """

    def __init__(self, *, p: OverheadParams = OVERHEADS,
                 config: Optional[SimConfig] = None, chunk: int = 32,
                 workers: int = 0) -> None:
        self.p = p
        self.config = config or SimConfig(events=1, trace=False)
        self.chunk = max(1, int(chunk))
        self.workers = int(workers)

    def score_placement(self, placement: Placement,
                        tenant: str = "model") -> float:
        from . import run as simrun
        return simrun.simulate_placement(placement, tenant=tenant, p=self.p,
                                         config=self.config,
                                         engine="auto").latency_cycles

    def __call__(self, design) -> float:
        return self.score_placement(design.placement, design.model.name)

    def score_batch(self, designs: Sequence) -> List[float]:
        items = [(d.model.name, d.placement) for d in designs]
        chunks = [items[i:i + self.chunk]
                  for i in range(0, len(items), self.chunk)]
        if self.workers > 1 and len(chunks) > 1:
            try:
                return self._score_parallel(chunks)
            except Exception:
                pass   # unpicklable payloads, missing fork, ... -> serial
        out: List[float] = []
        for ch in chunks:
            out.extend(_score_chunk((self.p, self.config, ch)))
        return out

    def _score_parallel(self, chunks) -> List[float]:
        import concurrent.futures as cf
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        payloads = [(self.p, self.config, ch) for ch in chunks]
        with cf.ProcessPoolExecutor(max_workers=self.workers,
                                    mp_context=ctx) as pool:
            out: List[float] = []
            for part in pool.map(_score_chunk, payloads):
                out.extend(part)
            return out
