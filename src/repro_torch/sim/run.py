"""Execute placed designs on the discrete-event array model (Tier-S).

The task graph for one event flowing through one instance mirrors the
Tier-A decomposition of :func:`repro_torch.core.perfmodel.end_to_end_cycles`:

    arrive -> PLIO ingest (one slice per shim column of the instance's box)
           -> layer 0 per-tile spans (cascade-skewed, from layer_occupancy)
           -> inter-layer edge (cascade gap / shared-mem / DMA with
              Manhattan routing)
           -> ... -> PLIO egress -> done

Durations come from the same calibrated Eq. (1)-(6) pieces the analytic
model sums, so a single-tenant run reproduces ``end_to_end_cycles`` — the
Fig. 9-style sim-vs-model report in ``benchmarks/sim_vs_model.py`` checks
this. Every priced task additionally carries its *blame decomposition* in
``args["blame"]`` (and ``args["delay_blame"]`` for launch skews): the same
Eq. (1)-(6) term split :func:`repro_torch.core.perfmodel.latency_blame` sums
analytically, attached per task so :mod:`repro_torch.obs.profile` can walk the
recorded causality DAG and attribute every cycle of the measured critical
path to a paper overhead category. What the simulator *adds* is resources: shim columns are capacity-1
servers shared by every co-resident tenant whose bounding box covers them,
so multi-tenant ingest serializes and the measured events/sec fall below
the congestion-free rate the Tier-A throughput model assumes.

**Pipelining.** ``SimConfig.pipeline_depth`` bounds the events in flight
per instance. Depth 1 (default) is the strictly serial pre-pipelining
model: event ``e+1`` arrives only when event ``e`` completes, matching the
``1 / latency`` per-replica rate. Depth ``d > 1`` admits event ``e+1`` as
soon as event ``e-d+1`` has completed, so stages overlap across events on
the FIFO resources they already occupy — the task graph no longer
serializes event ``e+1`` behind event ``e``'s final egress. Single-tenant
steady-state throughput then converges to ``1 / II`` where II is
:func:`repro_torch.core.perfmodel.initiation_interval_cycles` (the bottleneck
stage), and under multi-tenancy the shared shim columns throttle the
sustained *interval*, not just the latency. The dataflow latency of each
event is unchanged — measured arrival-to-completion latency can exceed it
by queueing time whenever admission outpaces the bottleneck stage — and
arrival order and completion order are both preserved.
"""
from __future__ import annotations

import dataclasses
import functools
import random
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import aie_arch, perfmodel
from repro_torch.core.aie_arch import OverheadParams, OVERHEADS
from repro_torch.core.placement import Placement
from repro_torch.core.tenancy import shim_transfer_cycles

from .array import ArrayResources
from .events import Task, TaskGraph
from .trace import ChromeTrace


@dataclasses.dataclass
class SimConfig:
    """Knobs of one simulation run (all cycle quantities in AIE cycles)."""

    events: int = 1                #: events to push through each instance
    pipeline_depth: int = 1        #: max in-flight events per instance;
                                   #: 1 = strictly serial (pre-pipelining)
    shim_contention: bool = True   #: serialize shared shim columns (Tier-S);
                                   #: False = congestion-free counterfactual
    shim_streams_per_col: int = aie_arch.SHIM_STREAMS_PER_COL
    include_plio: bool = True
    ideal: bool = False            #: zero all calibrated overheads
    seed: Optional[int] = None     #: seeds the arrival RNG (jitter + open loop)
    jitter_cycles: float = 0.0     #: uniform [0, jitter) per-event arrival jitter
    arrivals: Optional[object] = None
    """Open-loop arrival process: a :class:`repro_torch.serve.workload.ArrivalSpec`
    (lazy-imported: only open-loop runs need it). When
    set and open-loop, every event gets an *intended* arrival time on the
    cycle clock, drawn per instance from the shared seeded RNG; admission
    still respects ``pipeline_depth``, but sojourn is measured from the
    intended arrival, so a bounded depth only moves waiting to the
    admission gate without hiding it. Rates in the spec are events/sec of
    modeled device time. Overrides ``jitter_cycles``."""
    trace: bool = True             #: record a Chrome trace
    max_events: int = 5_000_000    #: engine event budget (runaway guard)

    @property
    def open_loop(self) -> bool:
        return (self.arrivals is not None
                and getattr(self.arrivals, "open_loop", False))


class InstanceStats:
    """Measurement mixin shared by the DES (:class:`InstanceSim`) and the
    fast path (:class:`repro_torch.sim.fastpath.FastInstance`).

    Every statistic derives from three per-event streams — admission
    completion (``root_cycles``), event completion (``completion_cycles``)
    and the optional intended ``arrivals`` — so both engines report
    through literally the same formulas: bit-exact completion streams
    imply bit-exact derived statistics. Derived lists are cached with
    :func:`functools.cached_property` because results are immutable once
    the run finishes (they used to be rebuilt on every property access).
    """

    label: str
    tenant: str
    replica: int
    arrivals: List[float]
    # Subclasses provide `root_cycles` / `completion_cycles` streams.

    @functools.cached_property
    def latencies(self) -> List[float]:
        """Dataflow (arrive-to-done) latency of every event, in order."""
        return [d - r for d, r in zip(self.completion_cycles,
                                      self.root_cycles)]

    @property
    def mean_latency_cycles(self) -> float:
        return sum(self.latencies) / len(self.latencies)

    @property
    def span_cycles(self) -> float:
        """First arrival to last completion."""
        return self.completion_cycles[-1] - self.root_cycles[0]

    @property
    def events_per_sec(self) -> float:
        return len(self.latencies) / (self.span_cycles * aie_arch.NS_PER_CYCLE
                                      * 1e-9)

    def steady_interval_cycles(self, *, warmup: Optional[int] = None,
                               drain: Optional[int] = None) -> float:
        """Mean completion-to-completion interval in the steady state.

        The first ``warmup`` and last ``drain`` completions (default: a
        quarter each) are discarded: the head measures the pipeline-fill
        transient, and the tail measures the drain, where the bottleneck
        stage no longer sees new ingest and completions come out faster
        than it can sustain. For a single pipelined tenant the middle
        window converges to the congestion-free
        ``initiation_interval_cycles``; under shim contention it measures
        the *throttled* interval the instance actually sustains.
        """
        done = self.completion_cycles
        if len(done) < 2:
            return self.span_cycles
        w = warmup if warmup is not None else len(done) // 4
        d = drain if drain is not None else len(done) // 4
        w = min(w, len(done) - 2)
        last = max(w + 1, len(done) - 1 - d)
        return (done[last] - done[w]) / (last - w)

    def steady_eps(self, *, warmup: Optional[int] = None,
                   drain: Optional[int] = None) -> float:
        """Steady-state events/sec (reciprocal of the sustained interval)."""
        return 1e9 / aie_arch.ns(
            self.steady_interval_cycles(warmup=warmup, drain=drain))

    @functools.cached_property
    def sojourn_cycles(self) -> List[float]:
        """Intended-arrival-to-completion time per event.

        Open-loop runs measure from the *intended* arrival (the offered
        clock), so admission-gate waiting counts as sojourn; closed-loop
        runs have no offered clock and fall back to the dataflow latency.
        """
        if not self.arrivals:
            return list(self.latencies)
        return [c - a for c, a in zip(self.completion_cycles, self.arrivals)]

    def queue_wait_cycles(self, base: Optional[float] = None) -> List[float]:
        """Per-event queueing wait: sojourn minus the dataflow latency.

        ``base`` defaults to the minimum observed latency — an event that
        hit an empty queue, which in a single-tenant run equals the
        analytic congestion-free latency exactly.
        """
        if not self.latencies:
            return []
        b = base if base is not None else min(self.latencies)
        return [max(0.0, s - b) for s in self.sojourn_cycles]

    @property
    def offered_eps(self) -> float:
        """Offered rate over the intended-arrival span (0 when closed)."""
        if len(self.arrivals) < 2:
            return 0.0
        span = self.arrivals[-1] - self.arrivals[0]
        if span <= 0:
            return 0.0
        return (len(self.arrivals) - 1) / (span * aie_arch.NS_PER_CYCLE
                                           * 1e-9)


@dataclasses.dataclass
class InstanceSim(InstanceStats):
    """Per-instance bookkeeping: the tasks of every event, then measurements."""

    label: str
    tenant: str
    replica: int
    placement: Placement
    event_tasks: List[Dict[str, object]]
    arrivals: List[float] = dataclasses.field(default_factory=list)
    """Intended (open-loop) arrival cycles per event; empty when closed."""

    @functools.cached_property
    def root_cycles(self) -> List[float]:
        """Admission (arrive-task) completion of every event, in order."""
        return [rec["root"].end for rec in self.event_tasks]

    @functools.cached_property
    def completion_cycles(self) -> List[float]:
        """Completion time of every event, in arrival order."""
        return [rec["done"].end for rec in self.event_tasks]


class ResultStats:
    """Aggregate measurement mixin shared by :class:`SimResult` (DES) and
    :class:`repro_torch.sim.fastpath.FastResult` — both expose ``instances``
    built on :class:`InstanceStats`, so fleet-level statistics come out of
    identical code on either engine."""

    instances: List[InstanceStats]

    @property
    def latency_cycles(self) -> float:
        """Mean per-event latency across all instances/events."""
        lats = [l for i in self.instances for l in i.latencies]
        return sum(lats) / len(lats)

    @property
    def latency_ns(self) -> float:
        return aie_arch.ns(self.latency_cycles)

    def throughput_eps(self) -> float:
        return sum(i.events_per_sec for i in self.instances)

    @functools.cached_property
    def _completion_stream(self) -> List[float]:
        """Merged sorted completion stream across instances (cached — the
        sort used to be redone on every ``steady_throughput_eps`` call)."""
        return sorted(t for i in self.instances for t in i.completion_cycles)

    def steady_throughput_eps(self, *, warmup: Optional[int] = None,
                              drain: Optional[int] = None) -> float:
        """Fleet steady-state events/sec (fill/drain transients discarded).

        Measured on the *merged* completion stream across instances, not as
        a sum of per-instance window estimates: under shim contention FIFO
        queueing makes one instance's completions arrive in bursts, which
        biases any per-instance interval window, while the merged stream's
        middle-window rate is the aggregate the fleet actually sustains.
        For one uncontended instance it converges to ``1 / II``; for
        contended schedules it is the measured counterpart of
        ``ArraySchedule.contended_eps(pipelined=True)``.
        """
        done = self._completion_stream
        n = len(done)
        if n < 2:
            return self.throughput_eps()
        w = warmup if warmup is not None else n // 4
        d = drain if drain is not None else n // 4
        w = min(w, n - 2)
        last = max(w + 1, n - 1 - d)
        interval = (done[last] - done[w]) / (last - w)
        return 1e9 / aie_arch.ns(interval)

    def per_instance_eps(self) -> Dict[str, float]:
        return {i.label: i.events_per_sec for i in self.instances}

    def sojourn_summary(self, *, warmup_frac: float = 0.1) -> Dict[str, float]:
        """Merged open-loop sojourn statistics (ns) across instances.

        The first ``warmup_frac`` of each instance's events is discarded —
        an open-loop queue starts empty, so the head of the run
        under-samples waiting relative to the stationary regime the
        analytic M/D/1 model (:func:`repro_torch.core.tenancy.latency_under_load`)
        predicts.
        """
        sojourns: List[float] = []
        for inst in self.instances:
            s = inst.sojourn_cycles
            sojourns.extend(s[int(len(s) * warmup_frac):])
        if not sojourns:
            return {"events": 0}
        sojourns = sorted(sojourns)

        def pct(q: float) -> float:
            return sojourns[min(len(sojourns) - 1,
                                int(q * len(sojourns)))]
        return {"events": len(sojourns),
                "mean_ns": aie_arch.ns(sum(sojourns) / len(sojourns)),
                "p50_ns": aie_arch.ns(pct(0.50)),
                "p99_ns": aie_arch.ns(pct(0.99)),
                "max_ns": aie_arch.ns(sojourns[-1])}


@dataclasses.dataclass
class SimResult(ResultStats):
    graph: TaskGraph
    arr: ArrayResources
    instances: List[InstanceSim]
    config: SimConfig
    trace: Optional[ChromeTrace]

    @property
    def makespan_cycles(self) -> float:
        return self.graph.makespan

    def shim_wait_cycles(self) -> float:
        """Total cycles transfers spent queued behind other tenants."""
        return sum(r.wait_cycles for r in self.arr.shim_resources().values())

    def bottleneck(self) -> Tuple[str, float]:
        """(resource name, utilization) of the busiest physical resource.

        Utilization is measured over the run's makespan across tiles, shim
        columns, and inter-layer edges. In a deep-pipelined steady state
        the bottleneck's utilization approaches 1.0 and names the stage
        that sets the initiation interval.
        """
        res = {**self.arr.tile_resources(), **self.arr.shim_resources(),
               **self.arr.edge_resources()}
        end = self.makespan_cycles
        best_name, best_util = "", 0.0
        for r in res.values():
            u = r.utilization(0.0, end)
            if u > best_util:
                best_name, best_util = r.name, u
        return best_name, best_util

    def stage_occupancy_cycles(self, instance: int = 0) -> Dict[str, float]:
        """Measured per-event occupancy of each pipeline stage of one
        instance, keyed by the :func:`repro_torch.core.perfmodel.pipeline_stages`
        stage names (``shim``, ``L{i}:{layer}``, ``L{i}>L{i+1}:{kind}``).

        Attribution filters resource spans by the instance's task-name
        prefix, so the numbers stay exact per instance even on shared shim
        columns — where a co-resident tenant's transfers then surface as
        *measured* shim-stage cycles above the analytic expectation. This
        is the measured side of the per-stage drift comparison
        (:meth:`repro_torch.obs.DriftMonitor`): a single-tenant run reproduces
        every analytic stage exactly, so any per-stage drift localizes the
        overhead constant that moved (see :mod:`repro_torch.core.calibrate`).
        """
        inst = self.instances[instance]
        n_events = max(1, len(inst.event_tasks))
        pfx = f"{inst.label}."

        def _busy(res) -> float:
            return sum(e - s for n, s, e, _ in res.spans
                       if n.startswith(pfx))

        out: Dict[str, float] = {}
        if self.config.include_plio:
            out["shim"] = max(
                (_busy(r) / n_events
                 for r in self.arr.shim_resources().values()), default=0.0)
        maps = inst.placement.model_mapping.mappings
        for i, (m, rect) in enumerate(zip(maps, inst.placement.rects)):
            busiest = 0.0
            for lr in range(m.rows):
                for lc in range(m.cols):
                    tile = self.arr.tile(rect.r0 + lr, rect.c0 + lc)
                    busiest = max(busiest, _busy(tile) / n_events)
            out[f"L{i}:{m.layer.name or m.layer.kind}"] = busiest
        for i, (kind, _, _) in enumerate(inst.event_tasks[0]["edges"]):
            res = self.arr.edge(f"{inst.label}.L{i}>L{i + 1}", kind)
            out[f"L{i}>L{i + 1}:{kind}"] = _busy(res) / n_events
        return out

    def export_metrics(self, registry=None):
        """Emit the run's telemetry into a :class:`repro_torch.obs.MetricsRegistry`.

        Gauges ``sim.resource.utilization{resource, kind}`` (busy fraction
        over the makespan, bottleneck attribution: the max names the
        II-setting stage), ``sim.resource.wait_cycles`` /
        ``sim.resource.max_queue`` (cross-tenant queueing on shared shim
        columns), per-instance latency histograms
        ``sim.event.latency_ns{instance}`` and steady-interval gauges, plus
        engine counters. Returns the registry (a fresh one when None).
        """
        from repro_torch.obs import MetricsRegistry
        reg = registry if registry is not None else MetricsRegistry()
        end = self.makespan_cycles
        groups = (("tile", self.arr.tile_resources()),
                  ("shim", self.arr.shim_resources()),
                  ("edge", self.arr.edge_resources()))
        for kind, res in groups:
            for r in res.values():
                reg.gauge("sim.resource.utilization",
                          {"resource": r.name, "kind": kind}
                          ).set(r.utilization(0.0, end))
                if r.wait_cycles > 0:
                    reg.gauge("sim.resource.wait_cycles",
                              {"resource": r.name}).set(r.wait_cycles)
                if r.max_queued > 0:
                    reg.gauge("sim.resource.max_queue",
                              {"resource": r.name}).set(r.max_queued)
        bname, butil = self.bottleneck()
        if bname:
            reg.gauge("sim.bottleneck.utilization",
                      {"resource": bname}).set(butil)
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
        reg.gauge("sim.engine.events_run").set(self.graph.sim.events_run)
        reg.gauge("sim.makespan_ns").set(aie_arch.ns(end))
        reg.gauge("sim.throughput.steady_eps").set(self.steady_throughput_eps())
        reg.gauge("sim.shim.wait_cycles_total").set(self.shim_wait_cycles())
        return reg


def _split(nbytes: int, n: int) -> List[int]:
    """Split ``nbytes`` into ``n`` integer shares that sum exactly."""
    base, rem = divmod(nbytes, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def _span_blame(m, occ, lr: int, lc: int, s: float, d: float, *,
                out_cascade: bool, p: OverheadParams,
                ideal: bool) -> Dict[str, Dict[str, float]]:
    """Blame annotations of one per-tile layer span (Eq. 4 decomposed).

    ``blame`` splits the busy ``duration``; ``delay_blame`` splits the
    launch skew ``delay``. Both reuse the same per-term helpers as the
    Tier-A :func:`repro_torch.core.perfmodel.latency_blame`, so summing the
    annotations down the simulated critical path reproduces the analytic
    decomposition — and scaling one category on the recorded graph
    (:func:`repro_torch.obs.profile.whatif`) projects the same schedule a
    re-simulation under ``perfmodel.scale_overheads`` would produce.
    """
    out: Dict[str, Dict[str, float]] = {}
    if m.layer.kind == "agg":
        if ideal:
            out["blame"] = {"compute": d}
        elif s > 0 or (m.rows > 1 and occ.lj > 0):
            # Skewed shared-memory chain: each tile owns one handoff, the
            # launch skew is the upstream tiles' handoffs (both "sync").
            out["blame"] = perfmodel.agg_blame(1, m.H1, m.W2, p=p,
                                               dtype=m.dtype)
            if s > 0:
                out["delay_blame"] = {"sync": s}
        else:
            # Unskewed fallback (rows == 1 or degenerate dur): the span
            # carries the whole A-AIE chain.
            out["blame"] = perfmodel.agg_blame(m.A, m.H1, m.W2, p=p,
                                               dtype=m.dtype)
        return out
    cascaded = m.B > 1
    blame = perfmodel.mm_loop_blame(m.W1, n_loops=float(occ.njl),
                                    cascaded=cascaded, p=p, dtype=m.dtype,
                                    ideal=ideal)
    if lc == m.cols - 1 and not ideal:
        for k, v in perfmodel.mm_epilogue_blame(
                m.H1, m.W2, out_cascade=out_cascade,
                bias_relu=bool(m.layer.bias or m.layer.relu), p=p).items():
            blame[k] = blame.get(k, 0.0) + v
    out["blame"] = blame
    if lc > 0:
        # FIFO-fill skew: lc whole j-loop periods of the upstream columns.
        out["delay_blame"] = perfmodel.mm_loop_blame(
            m.W1, n_loops=float(lc), cascaded=cascaded, p=p, dtype=m.dtype,
            ideal=ideal)
    return out


def _build_instance(g: TaskGraph, arr: ArrayResources, placement: Placement,
                    *, tenant: str, replica: int, n_events: int,
                    p: OverheadParams, cfg: SimConfig,
                    rng: random.Random) -> InstanceSim:
    label = f"{tenant}#{replica}"
    mm = placement.model_mapping
    maps = mm.mappings
    links = placement.cascade_links()
    ecs = perfmodel.edge_comms(placement, p=p, ideal=cfg.ideal)
    cols, t_in, t_out = shim_transfer_cycles(
        placement, p=p, streams_per_col=cfg.shim_streams_per_col,
        ideal=cfg.ideal)
    in_bytes = maps[0].layer.in_bytes
    out_bytes = maps[-1].layer.out_bytes

    depth = max(1, cfg.pipeline_depth)
    arrival_cycles: Optional[List[float]] = None
    if cfg.open_loop:
        # Lazy import: only open-loop runs need the workload module (the
        # repro_torch.serve package import pulls torch).
        from repro_torch.serve import workload
        arrival_cycles = workload.arrival_cycles(cfg.arrivals, n_events,
                                                 rng=rng)
    roots: List[Task] = []
    dones: List[Task] = []
    ev_tasks: List[Dict[str, object]] = []
    for e in range(n_events):
        ev = f"{label}.e{e}"
        if arrival_cycles is not None:
            # Open loop: the offered clock fires at the intended arrival
            # regardless of queue state; admission (below) may hold the
            # event at the gate, and sojourn is measured from this clock.
            offered = g.task(f"{ev}.offered", delay=arrival_cycles[e],
                             record=False)
            root = g.task(f"{ev}.arrive", record=False).after(offered)
        else:
            jit = (rng.uniform(0.0, cfg.jitter_cycles)
                   if cfg.jitter_cycles > 0 else 0.0)
            root = g.task(f"{ev}.arrive", delay=jit, record=False)
        # Pipelined admission: at most ``depth`` events in flight. Event e
        # waits for event e-depth to complete (depth 1 = the strictly
        # serial pre-pipelining graph, where e waits on e-1's egress) and,
        # when overlap is allowed, on the previous arrival so the arrival
        # order — and with it, via FIFO resources, the completion order —
        # is preserved.
        if e >= depth:
            root.after(dones[e - depth])
        if e > 0 and (depth > 1 or arrival_cycles is not None):
            root.after(roots[e - 1])
        roots.append(root)
        rec: Dict[str, object] = {"root": root, "ingest": [], "edges": [],
                                  "layers": [], "egress": []}
        cur = root
        if cfg.include_plio:
            ingest = [g.task(f"{ev}.load", resource=arr.shim(c, label),
                             duration=t_in, bytes=b, cat="ingest",
                             args={"ev": ev, "tenant": tenant, "label": label,
                                   "blame": {"shim_ingest": t_in}}).after(root)
                      for c, b in zip(cols, _split(in_bytes, len(cols)))]
            rec["ingest"] = ingest
            cur = g.task(f"{ev}.loaded", record=False).after(*ingest)
        for i, m in enumerate(maps):
            out_cas = i < len(links) and links[i]
            occ = perfmodel.layer_occupancy(m, out_cascade=out_cas, p=p,
                                            ideal=cfg.ideal)
            rect = placement.rects[i]
            lname = m.layer.name or f"L{i}"
            spans = [g.task(f"{ev}.{lname}",
                            resource=arr.tile(rect.r0 + lr, rect.c0 + lc),
                            delay=s, duration=d, cat="compute",
                            args={"ev": ev, "tenant": tenant, "label": label,
                                  **_span_blame(m, occ, lr, lc, s, d,
                                                out_cascade=out_cas, p=p,
                                                ideal=cfg.ideal)}).after(cur)
                     for lr, lc, s, d in occ.spans]
            rec["layers"].append(spans)
            ldone = g.task(f"{ev}.{lname}.done", record=False).after(*spans)
            if i == len(maps) - 1:
                cur = ldone
                continue
            # inter-layer edge, priced once by perfmodel.edge_comms (the
            # same EdgeComm the analytic sum and the pipeline stages use)
            ec = ecs[i]
            edge = g.task(f"{ev}.{lname}>{ec.kind}",
                          resource=arr.edge(f"{label}.L{i}>L{i + 1}", ec.kind),
                          duration=ec.cycles, bytes=ec.data_bytes, cat="edge",
                          args={"ev": ev, "tenant": tenant, "label": label,
                                "blame": {f"comm_{ec.kind}": ec.cycles}}
                          ).after(ldone)
            rec["edges"].append((ec.kind, edge, ec.data_bytes))
            cur = edge
        if cfg.include_plio:
            egress = [g.task(f"{ev}.store", resource=arr.shim(c, label),
                             duration=t_out, bytes=b, cat="egress",
                             args={"ev": ev, "tenant": tenant, "label": label,
                                   "blame": {"shim_egress": t_out}}).after(cur)
                      for c, b in zip(cols, _split(out_bytes, len(cols)))]
            rec["egress"] = egress
            cur = g.task(f"{ev}.done", record=False).after(*egress)
        rec["done"] = cur
        dones.append(cur)
        ev_tasks.append(rec)
    return InstanceSim(label=label, tenant=tenant, replica=replica,
                       placement=placement, event_tasks=ev_tasks,
                       arrivals=list(arrival_cycles or []))


def _finalize(g: TaskGraph, arr: ArrayResources, insts: List[InstanceSim],
              cfg: SimConfig, trace: Optional[ChromeTrace]) -> SimResult:
    g.run(max_events=cfg.max_events)
    if trace is not None:
        for inst in insts:
            for e, (t0, lat) in enumerate(zip(inst.root_cycles,
                                              inst.latencies)):
                trace.span("events", inst.label, f"e{e}", t0, lat,
                           args={"latency_ns": aie_arch.ns(lat)})
    return SimResult(graph=g, arr=arr, instances=insts, config=cfg,
                     trace=trace)


def _maybe_fast(builder, cfg: SimConfig, tracer, engine: str):
    """Engine dispatch shared by the two simulate entry points.

    Returns a :class:`repro_torch.sim.fastpath.FastResult` when the fast path
    handles this run, or ``None`` meaning "run the DES". ``engine="fast"``
    raises :class:`~repro_torch.sim.fastpath.FastpathUnsupported` instead of
    falling back; ``engine="auto"`` records the fallback reason in the
    ``sim.fastpath.fallbacks`` counters and quietly yields to the DES.
    """
    if engine == "des":
        return None
    if engine not in ("fast", "auto"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'des', 'fast' or 'auto')")
    from . import fastpath
    reason = fastpath.supports(cfg, tracer=tracer)
    if reason is not None:
        if engine == "fast":
            raise fastpath.FastpathUnsupported(reason)
        fastpath.record_fallback(reason)
        return None
    return builder(fastpath)


def simulate_placement(placement: Placement, *, tenant: str = "model",
                       p: OverheadParams = OVERHEADS,
                       config: Optional[SimConfig] = None,
                       tracer: Optional[ChromeTrace] = None,
                       engine: str = "des") -> SimResult:
    """Simulate one standalone instance end to end (Tier-S single tenant).

    ``tracer`` lets the caller supply an existing :class:`ChromeTrace`
    (e.g. one already carrying fleet serving spans) so simulator spans land
    in the same unified timeline; otherwise one is created per run when
    ``config.trace`` is set.

    ``engine`` selects the execution engine: ``"des"`` (default) runs the
    event-driven simulator; ``"fast"`` demands the compiled replay engine
    (:mod:`repro_torch.sim.fastpath` — bit-exact completion/sojourn cycles, but
    no task graph, resource spans, or trace) and raises
    :class:`~repro_torch.sim.fastpath.FastpathUnsupported` when the requested
    features need the DES; ``"auto"`` takes the fast path when eligible
    and silently falls back otherwise. See the package docstring for the
    exact fallback rules.
    """
    cfg = config or SimConfig()
    fast = _maybe_fast(
        lambda fp: fp.simulate_placement_fast(placement, tenant=tenant, p=p,
                                              config=cfg),
        cfg, tracer, engine)
    if fast is not None:
        return fast
    trace = tracer if tracer is not None else (
        ChromeTrace(meta={"mode": "single", "seed": cfg.seed,
                          "tenant": tenant}) if cfg.trace else None)
    g = TaskGraph(trace=trace)
    arr = ArrayResources(shim_shared=cfg.shim_contention)
    rng = random.Random(cfg.seed)
    inst = _build_instance(g, arr, placement, tenant=tenant, replica=0,
                           n_events=cfg.events, p=p, cfg=cfg, rng=rng)
    return _finalize(g, arr, [inst], cfg, trace)


def simulate_schedule(schedule, *, p: OverheadParams = OVERHEADS,
                      config: Optional[SimConfig] = None,
                      tracer: Optional[ChromeTrace] = None,
                      engine: str = "des") -> SimResult:
    """Simulate a multi-tenant :class:`repro_torch.core.tenancy.ArraySchedule`.

    All instances ingest concurrently through the *shared* shim columns
    under their boxes; with ``config.shim_contention`` (default) transfers
    sharing a column serialize, which is the contention-aware replacement
    for the congestion-free ``R / latency`` throughput model.
    ``tracer`` injects an existing :class:`ChromeTrace` for a unified
    timeline (see :func:`simulate_placement`); ``engine`` selects the
    execution engine exactly as in :func:`simulate_placement`.
    """
    cfg = config or SimConfig()
    fast = _maybe_fast(
        lambda fp: fp.simulate_schedule_fast(schedule, p=p, config=cfg),
        cfg, tracer, engine)
    if fast is not None:
        return fast
    trace = tracer if tracer is not None else (
        ChromeTrace(meta={"mode": "schedule", "seed": cfg.seed,
                          "instances": len(schedule.instances)})
        if cfg.trace else None)
    g = TaskGraph(trace=trace)
    arr = ArrayResources(rows=schedule.rows, cols=schedule.cols,
                         shim_shared=cfg.shim_contention)
    rng = random.Random(cfg.seed)
    insts = [_build_instance(g, arr, inst.placement, tenant=inst.tenant,
                             replica=inst.replica, n_events=cfg.events,
                             p=p, cfg=cfg, rng=rng)
             for inst in schedule.instances]
    return _finalize(g, arr, insts, cfg, trace)


def simulated_latency_cycles(placement: Placement, *,
                             p: OverheadParams = OVERHEADS,
                             config: Optional[SimConfig] = None) -> float:
    cfg = config or SimConfig(events=1, trace=False)
    return simulate_placement(placement, p=p, config=cfg).latency_cycles


def sweep_latency_cycles(placements, *, p: OverheadParams = OVERHEADS,
                         config: Optional[SimConfig] = None,
                         stages: bool = False, engine: str = "des"):
    """Tier-S sweep driver: simulate each placement and return the measured
    end-to-end cycles as a list (same order as ``placements``).

    This is the measurement hook of the calibration harness
    (:mod:`repro_torch.core.calibrate`): the analytic model is least-squares-fit
    against exactly these numbers. ``stages=True`` additionally returns one
    :meth:`SimResult.stage_occupancy_cycles` dict per placement for the
    per-stage drift localization path. ``engine="fast"``/``"auto"`` runs
    the sweep on the compiled replay engine — both the latencies and the
    stage-occupancy dicts are bit-exact with the DES, so calibration fits
    are unchanged while the sweep loses its DES construction cost.
    """
    cfg = config or SimConfig(events=1, trace=False)
    use_fast = False
    if engine != "des":
        from . import fastpath
        reason = fastpath.supports(cfg)
        if reason is not None and engine == "fast":
            raise fastpath.FastpathUnsupported(reason)
        use_fast = reason is None
        if not use_fast:
            fastpath.record_fallback(reason)
    lats: List[float] = []
    stage_dicts: List[Dict[str, float]] = []
    for pl in placements:
        if use_fast:
            res = fastpath.simulate_placement_fast(pl, p=p, config=cfg,
                                                   stages=stages)
        else:
            res = simulate_placement(pl, p=p, config=cfg)
        lats.append(res.latency_cycles)
        if stages:
            stage_dicts.append(res.stage_occupancy_cycles())
    return (lats, stage_dicts) if stages else lats


def rescorer(*, p: OverheadParams = OVERHEADS,
             config: Optional[SimConfig] = None, fast: bool = True,
             chunk: int = 32, workers: int = 0
             ) -> Callable[["object"], float]:
    """Tier-S re-scoring hook for :func:`repro_torch.core.dse.search`.

    Returns a callable mapping a ``DSEResult`` to its simulated end-to-end
    latency in cycles; ``dse.search(model, rescore=sim.rescorer())`` then
    re-ranks its placement-validated top-K designs by simulated latency.

    ``fast=True`` (default) returns a :class:`repro_torch.sim.fastpath.Rescorer`
    backed by the compiled replay engine — same cycles bit-exact, and it
    additionally exposes ``score_batch`` so ``dse.search`` amortizes
    dispatch over the whole top-K in ``chunk``-sized batches (``workers``
    > 1 scores chunks in parallel processes). Configs that need a DES-only
    feature (e.g. ``trace=True``) fall back per design automatically.
    ``fast=False`` returns the plain DES closure.
    """
    cfg = config or SimConfig(events=1, trace=False)
    if fast:
        from .fastpath import Rescorer
        return Rescorer(p=p, config=cfg, chunk=chunk, workers=workers)

    def _score(design) -> float:
        return simulate_placement(design.placement,
                                  tenant=design.model.name, p=p,
                                  config=cfg).latency_cycles
    return _score


# ---------------------------------------------------------------------------
# Structural invariants (consumed by tests and the benchmark's verify pass)
# ---------------------------------------------------------------------------

def invariant_errors(result: SimResult) -> List[str]:
    """Conservation/ordering violations of a finished run (empty = clean).

    Checks: (1) no resource span overlaps another on the same resource —
    in particular no tile is double-booked; (2) byte conservation — every
    event's ingest slices sum to the first layer's input bytes, each
    inter-layer edge carries exactly the producer's output bytes, egress
    slices sum to the last layer's output; (3) span nesting — every child
    task of an event lies within the event's [arrive, done] envelope, and
    layer i+1 never starts before layer i finishes.
    """
    if not isinstance(result, SimResult):
        raise TypeError(
            "invariant_errors needs a DES SimResult with recorded resource "
            "spans; the fast path keeps none (run with engine='des')")
    errs: List[str] = []
    resources = {**result.arr.tile_resources(),
                 **result.arr.shim_resources()}
    for key, res in resources.items():
        spans = sorted(res.spans, key=lambda s: s[1])
        for (na, sa, ea, _), (nb, sb, eb, _) in zip(spans, spans[1:]):
            if sb < ea - 1e-9:
                errs.append(f"{res.name}: '{na}' [{sa},{ea}) overlaps "
                            f"'{nb}' [{sb},{eb})")
    for inst in result.instances:
        mm = inst.placement.model_mapping
        in_bytes = mm.mappings[0].layer.in_bytes
        out_bytes = mm.mappings[-1].layer.out_bytes
        for e, rec in enumerate(inst.event_tasks):
            ev = f"{inst.label}.e{e}"
            if rec["ingest"]:
                got = sum(t.bytes for t in rec["ingest"])
                if got != in_bytes:
                    errs.append(f"{ev}: ingest {got} B != in_bytes {in_bytes}")
            for i, (kind, edge, data) in enumerate(rec["edges"]):
                want = mm.mappings[i].layer.out_bytes
                if edge.bytes != want:
                    errs.append(f"{ev}: edge {i} ({kind}) carries "
                                f"{edge.bytes} B != producer out {want}")
            if rec["egress"]:
                got = sum(t.bytes for t in rec["egress"])
                if got != out_bytes:
                    errs.append(f"{ev}: egress {got} B != out_bytes {out_bytes}")
            t0, t1 = rec["root"].end, rec["done"].end
            children = (list(rec["ingest"]) + list(rec["egress"])
                        + [t for spans in rec["layers"] for t in spans]
                        + [edge for _, edge, _ in rec["edges"]])
            for t in children:
                if t.start < t0 - 1e-9 or t.end > t1 + 1e-9:
                    errs.append(f"{ev}: task {t.name} [{t.start},{t.end}] "
                                f"escapes event envelope [{t0},{t1}]")
            for i in range(len(rec["layers"]) - 1):
                end_i = max(t.end for t in rec["layers"][i])
                start_next = min(t.start for t in rec["layers"][i + 1])
                if start_next < end_i - 1e-9:
                    errs.append(f"{ev}: layer {i + 1} starts {start_next} "
                                f"before layer {i} ends {end_i}")
    return errs
