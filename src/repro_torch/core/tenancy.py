"""Multi-tenant array scheduling: replica packing + throughput-aware DSE.

The paper's DSE (§5.2) optimizes the latency of ONE model instance, and its
winning designs occupy only a small fraction of the 8 x 38 = 304-tile VEK280
array (e.g. the latency-optimal Deepsets-32 design uses 31 tiles). Trigger
systems care about *throughput at bounded latency*: events arrive at a fixed
rate and every idle tile is wasted capacity. This module adds the missing
spatial-multi-tenancy axis:

  * :func:`pack` places R independent instances (replicas of one model, or a
    heterogeneous mix of tenants) onto the shared grid. Each instance is the
    rigid translation of a standalone §5.2 placement, so its cascade links
    and DMA Manhattan distances — hence its Tier-A latency — are *unchanged*
    (see :meth:`repro_torch.core.placement.Placement.translated`). Instances
    reserve their full bounding box, which keeps intra-instance DMA routes
    disjoint across tenants (the Tier-A model assumes congestion-free
    routing; box isolation makes that assumption hold by construction).
  * The shared PLIO budget is a fleet-wide constraint: the array edge has P
    ports total, and tenant i consumes ``A_1*B_1 + A_n*C_n`` of them, so
    Σ_i ports_i <= P bounds the replica count even when tiles remain.
  * :func:`throughput_frontier` runs the throughput-aware DSE: it takes the
    per-model {tiles, latency, II} Pareto frontier from :func:`repro_torch.core.
    dse.search` and, for each design, packs as many replicas as tiles +
    PLIO allow. Replicas operate on independent events, and each replica is
    *pipelined*: the cascade-chained columns overlap event ``k+1``'s ingest
    with event ``k``'s compute, so a replica sustains one event per
    initiation interval (``perfmodel.initiation_interval_cycles``, the
    bottleneck stage; II <= latency), not one per end-to-end latency. The
    modeled fleet rate is therefore ``Σ 1/II_i`` at *unchanged per-event
    latency* — small-tile designs that lose the single-instance latency
    race, and fewer-replica designs with deep pipelines, can both win on
    events/sec, which is why the grown frontier (not just the latency
    winner) is the right input. ``pipelined=False`` restores the serial
    ``R / latency`` model for comparison.
  * :func:`pack_mix` schedules a heterogeneous tenant mix (as deployed
    triggers do — several taggers sharing one device), backing designs off
    along their frontiers until the mix fits.

The serving-side counterpart is :class:`repro_torch.serve.fleet.FleetServer`,
which dispatches measured micro-batches across R compiled replicas and
reports wall-clock percentiles next to these Tier-A numbers.

PLIO ingest is *not* congestion-free across tenants: instances load/store
through the shim DMA of the columns under their bounding box, and boxes
that stack vertically share those columns. :func:`shim_transfer_cycles`
computes each instance's per-column occupancy, :meth:`ArraySchedule.
shim_contention` prices the serialization analytically (fluid model), and
``throughput_frontier(contention="sim")`` measures it with the Tier-S
discrete-event simulator (:mod:`repro_torch.sim`).
"""
from __future__ import annotations

import dataclasses
import decimal
import math
from typing import Dict, List, Optional, Sequence, Tuple

from . import aie_arch, dse, perfmodel
from .aie_arch import OverheadParams, OVERHEADS
from .dse import DSEResult
from .layerspec import ModelSpec
from .placement import (Placement, Rect, find_free_anchor, mark_occupied)


# ---------------------------------------------------------------------------
# Shim-column ingest model (closes the congestion-free PLIO assumption)
# ---------------------------------------------------------------------------

def shim_transfer_cycles(placement: Placement, *,
                         p: OverheadParams = OVERHEADS,
                         streams_per_col: int = aie_arch.SHIM_STREAMS_PER_COL,
                         ideal: bool = False
                         ) -> Tuple[Tuple[int, ...], float, float]:
    """Per-column PLIO occupancy ``(columns, t_in, t_out)`` of one instance.

    Kept as the tenancy-side name; the computation lives in
    :func:`repro_torch.core.perfmodel.shim_stage_cycles`, where it doubles as the
    shim *pipeline stage* of the initiation-interval decomposition.
    """
    return perfmodel.shim_stage_cycles(placement, p=p,
                                       streams_per_col=streams_per_col,
                                       ideal=ideal)


@dataclasses.dataclass(frozen=True)
class ShimContention:
    """Analytic serialized-ingest report for one schedule.

    Fluid approximation of the capacity-1 shim columns the Tier-S simulator
    models exactly: each instance demands ``(t_in + t_out) / period`` of
    every column under its box; a column whose summed demand exceeds 1.0
    saturates and throttles every sharer proportionally. Per-event latency
    is unchanged (transfers still complete), only sustained events/sec drop.

    ``basis`` records the per-instance period used: ``"interval"`` (the
    default — each replica offers one event per pipelined initiation
    interval, so columns saturate sooner and contention throttles the
    *interval*) or ``"latency"`` (the serial 1/latency offered rate of the
    pre-pipelining model).
    """

    column_util: Dict[int, float]       #: per shim column: Σ demand (can be > 1)
    column_sharers: Dict[int, int]      #: per shim column: instances using it
    factors: Tuple[float, ...]          #: per instance: throughput throttle <= 1
    eps_free: float                     #: congestion-free Σ 1/period
    eps_contended: float                #: throttled Σ factor_i / period_i
    basis: str = "interval"             #: 'interval' (pipelined) | 'latency'

    @property
    def shared_cols(self) -> int:
        return sum(1 for n in self.column_sharers.values() if n > 1)

    @property
    def penalty(self) -> float:
        """Fractional events/sec lost to shim serialization (0 = none)."""
        if self.eps_free <= 0:
            return 0.0
        return 1.0 - self.eps_contended / self.eps_free


@dataclasses.dataclass(frozen=True)
class Instance:
    """One placed tenant instance: a standalone design translated onto the
    shared grid at ``offset`` (row, col of its bounding box's bottom-left)."""

    tenant: str
    replica: int
    design: DSEResult
    placement: Placement
    offset: Tuple[int, int]

    @property
    def latency_ns(self) -> float:
        return self.design.latency.total_ns

    @property
    def interval_cycles(self) -> float:
        """Congestion-free pipelined initiation interval of this instance.

        Stage durations and the box width are translation-invariant, so the
        translated placement's II equals the standalone design's; the design
        carries it pre-computed from the DSE re-scoring pass.
        """
        if self.design.interval_cycles is not None:
            return self.design.interval_cycles
        return perfmodel.initiation_interval_cycles(self.placement)

    @property
    def interval_ns(self) -> float:
        return aie_arch.ns(self.interval_cycles)

    @property
    def tiles(self) -> int:
        return self.design.mapping.total_tiles

    @property
    def plio_ports(self) -> int:
        return self.design.mapping.plio_ports_needed()

    @property
    def bbox(self) -> Rect:
        return self.placement.bounding_box()

    @property
    def shim_cols(self) -> Tuple[int, ...]:
        """Shim columns this instance loads/stores through (under its box)."""
        return self.placement.shim_columns()


@dataclasses.dataclass(frozen=True)
class ArraySchedule:
    """A multi-tenant assignment of the shared AIE array."""

    instances: Tuple[Instance, ...]
    rows: int = aie_arch.ARRAY_ROWS
    cols: int = aie_arch.ARRAY_COLS
    plio: int = aie_arch.PLIO_PORTS

    @property
    def total_tiles(self) -> int:
        return sum(i.tiles for i in self.instances)

    @property
    def plio_ports_used(self) -> int:
        return sum(i.plio_ports for i in self.instances)

    @property
    def utilization(self) -> float:
        return self.total_tiles / (self.rows * self.cols)

    def per_tenant(self) -> Dict[str, List[Instance]]:
        out: Dict[str, List[Instance]] = {}
        for i in self.instances:
            out.setdefault(i.tenant, []).append(i)
        return out

    def throughput_eps(self, *, pipelined: bool = True) -> float:
        """Congestion-free modeled fleet events/sec.

        Replicas work independent events; with ``pipelined`` (default) each
        sustains one event per initiation interval (``Σ 1/II_i``) once its
        pipeline is primed, at unchanged per-event latency. ``pipelined=
        False`` gives the serial pre-pipelining ``Σ 1/latency_i`` rate.
        See :meth:`contended_eps` for the shim-aware figure.
        """
        if pipelined:
            return sum(1e9 / i.interval_ns for i in self.instances)
        return sum(1e9 / i.latency_ns for i in self.instances)

    def shim_contention(self, *, p: OverheadParams = OVERHEADS,
                        streams_per_col: int = aie_arch.SHIM_STREAMS_PER_COL,
                        pipelined: bool = True) -> ShimContention:
        """Analytic serialized-ingest model over the shared shim columns.

        Each instance offers one event per ``period`` (its initiation
        interval when ``pipelined``, its latency otherwise) and occupies
        every column under its box ``t_in + t_out`` cycles per event. The
        pipelined basis is the strictly harder regime: II <= latency means
        higher offered rates, so shared columns saturate sooner and the
        throttle hits the *interval* each replica can sustain, not just a
        latency-derived rate.
        """
        util: Dict[int, float] = {}
        sharers: Dict[int, int] = {}
        per_inst: List[Tuple[Tuple[int, ...], float]] = []
        for inst in self.instances:
            cols, t_in, t_out = shim_transfer_cycles(
                inst.placement, p=p, streams_per_col=streams_per_col)
            period = (inst.interval_cycles if pipelined
                      else aie_arch.cycles_from_ns(inst.latency_ns))
            demand = (t_in + t_out) / period
            for c in cols:
                util[c] = util.get(c, 0.0) + demand
                sharers[c] = sharers.get(c, 0) + 1
            per_inst.append((cols, period))
        factors = tuple(
            min([1.0] + [1.0 / util[c] for c in cols if util[c] > 1.0])
            for cols, _ in per_inst)
        eps_free = self.throughput_eps(pipelined=pipelined)
        eps_cont = sum(f * 1e9 / aie_arch.ns(period)
                       for f, (_, period) in zip(factors, per_inst))
        return ShimContention(column_util=util, column_sharers=sharers,
                              factors=factors, eps_free=eps_free,
                              eps_contended=eps_cont,
                              basis="interval" if pipelined else "latency")

    def contended_eps(self, *, p: OverheadParams = OVERHEADS,
                      pipelined: bool = True) -> float:
        """Modeled events/sec with the serialized-ingest penalty applied."""
        return self.shim_contention(p=p, pipelined=pipelined).eps_contended

    def validate(self) -> List[str]:
        """Structural legality check; returns a list of violations (empty
        when the schedule is legal). Checks grid bounds, pairwise bounding-
        box disjointness, the shared PLIO budget, and that every instance
        kept the cascade links of its standalone design."""
        errs: List[str] = []
        boxes = [i.bbox for i in self.instances]
        for inst, box in zip(self.instances, boxes):
            if not (0 <= box.r0 and box.r1 <= self.rows
                    and 0 <= box.c0 and box.c1 <= self.cols):
                errs.append(f"{inst.tenant}#{inst.replica}: out of bounds {box}")
        for a in range(len(boxes)):
            for b in range(a + 1, len(boxes)):
                if boxes[a].overlaps(boxes[b]):
                    ia, ib = self.instances[a], self.instances[b]
                    errs.append(f"{ia.tenant}#{ia.replica} overlaps "
                                f"{ib.tenant}#{ib.replica}")
        if self.plio_ports_used > self.plio:
            errs.append(f"PLIO over budget: {self.plio_ports_used} > {self.plio}")
        for inst in self.instances:
            if (inst.placement.cascade_links()
                    != inst.design.placement.cascade_links()):
                errs.append(f"{inst.tenant}#{inst.replica}: cascade links "
                            f"changed by translation")
        return errs

    def summary(self) -> dict:
        tenants = {t: len(v) for t, v in self.per_tenant().items()}
        sc = self.shim_contention(pipelined=False)
        scp = self.shim_contention(pipelined=True)
        return {"instances": len(self.instances), "tenants": tenants,
                "tiles": self.total_tiles,
                "utilization": round(self.utilization, 4),
                "plio_ports": self.plio_ports_used,
                "modeled_eps": self.throughput_eps(pipelined=False),
                "modeled_eps_contended": sc.eps_contended,
                "modeled_eps_pipelined": scp.eps_free,
                "modeled_eps_pipelined_contended": scp.eps_contended,
                "shim_cols_shared": sc.shared_cols,
                "shim_penalty": round(sc.penalty, 4),
                "shim_penalty_pipelined": round(scp.penalty, 4)}


def _normalized(pl: Placement) -> Placement:
    """Translate a placement so its bounding box sits at (0, 0)."""
    box = pl.bounding_box()
    if box.r0 == 0 and box.c0 == 0:
        return pl
    return pl.translated(-box.r0, -box.c0)


class _Packer:
    """Incremental bottom-left bounding-box packer over one occupancy grid.

    Mirrors the paper's intra-model placement discipline one level up:
    each added instance takes the free (row, col) anchor with the minimum
    row index, then minimum column index, that fits its whole bounding box.
    """

    def __init__(self, rows: int, cols: int, plio: int):
        self.rows, self.cols, self.plio = rows, cols, plio
        self._occ = [[False] * cols for _ in range(rows)]
        self._instances: List[Instance] = []
        self._ports_used = 0
        self._counts: Dict[str, int] = {}

    def add(self, tenant: str, design: DSEResult) -> bool:
        """Try to place one more instance; False (state unchanged) if the
        bounding box does not fit or the shared PLIO budget is exceeded."""
        ports = design.mapping.plio_ports_needed()
        if self._ports_used + ports > self.plio:
            return False
        base = _normalized(design.placement)
        box = base.bounding_box()
        anchor = find_free_anchor(self._occ, box.h, box.w)
        if anchor is None:
            return False
        r0, c0 = anchor
        mark_occupied(self._occ, Rect(r0, c0, box.h, box.w))
        self._ports_used += ports
        idx = self._counts.get(tenant, 0)
        self._counts[tenant] = idx + 1
        self._instances.append(
            Instance(tenant=tenant, replica=idx, design=design,
                     placement=base.translated(r0, c0), offset=(r0, c0)))
        return True

    def schedule(self) -> ArraySchedule:
        return ArraySchedule(instances=tuple(self._instances), rows=self.rows,
                             cols=self.cols, plio=self.plio)


def pack(designs: Sequence[Tuple[str, DSEResult]], *,
         rows: int = aie_arch.ARRAY_ROWS,
         cols: int = aie_arch.ARRAY_COLS,
         plio: int = aie_arch.PLIO_PORTS) -> Optional[ArraySchedule]:
    """Pack instances (tenant-name, standalone design) onto the shared grid.

    Instances are placed in the given order with bottom-left bounding-box
    packing; the first instance therefore lands at offset (0, 0), so packing
    a single instance reproduces the standalone §5.2 placement exactly.

    Returns None when any instance does not fit (tiles/geometry) or the
    shared PLIO budget is exceeded.
    """
    pk = _Packer(rows, cols, plio)
    for tenant, design in designs:
        if not pk.add(tenant, design):
            return None
    return pk.schedule()


def pack_replicas(design: DSEResult, replicas: int, *,
                  tenant: Optional[str] = None,
                  rows: int = aie_arch.ARRAY_ROWS,
                  cols: int = aie_arch.ARRAY_COLS,
                  plio: int = aie_arch.PLIO_PORTS) -> Optional[ArraySchedule]:
    """Pack ``replicas`` copies of one design; None if they do not fit."""
    name = tenant or design.model.name
    return pack([(name, design)] * replicas, rows=rows, cols=cols, plio=plio)


def pack_max_replicas(design: DSEResult, *,
                      tenant: Optional[str] = None,
                      rows: int = aie_arch.ARRAY_ROWS,
                      cols: int = aie_arch.ARRAY_COLS,
                      plio: int = aie_arch.PLIO_PORTS,
                      cap: Optional[int] = None
                      ) -> Optional[ArraySchedule]:
    """Greedily pack replicas of one design until the grid or the shared
    PLIO budget refuses the next one; None if even one replica does not
    fit. Incremental (one occupancy grid, one pass) — bottom-left packing
    never benefits from removing an earlier replica, so greedy is exact."""
    name = tenant or design.model.name
    pk = _Packer(rows, cols, plio)
    while pk.add(name, design):
        if cap is not None and len(pk._instances) >= cap:
            break
    if not pk._instances:
        return None
    return pk.schedule()


def max_replicas(design: DSEResult, *,
                 rows: int = aie_arch.ARRAY_ROWS,
                 cols: int = aie_arch.ARRAY_COLS,
                 plio: int = aie_arch.PLIO_PORTS,
                 cap: Optional[int] = None) -> int:
    """Largest R for which :func:`pack_replicas` succeeds (0 if even one
    replica does not fit)."""
    sched = pack_max_replicas(design, rows=rows, cols=cols, plio=plio,
                              cap=cap)
    return 0 if sched is None else len(sched.instances)


# ---------------------------------------------------------------------------
# Throughput-aware DSE
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ThroughputPoint:
    """One point of the {latency, II, events/sec} frontier for a model.

    Serial figures (the pre-pipelining story): ``events_per_sec`` is the
    congestion-free ``R / latency`` and ``events_per_sec_contended`` applies
    the shim serialized-ingest penalty on the latency basis. Pipelined
    figures: ``interval_ns`` is one replica's congestion-free initiation
    interval, ``events_per_sec_pipelined`` the congestion-free ``Σ 1/II``
    and ``events_per_sec_pipelined_contended`` the shim-throttled pipelined
    rate — analytic by default, measured by the Tier-S simulator when the
    frontier was built with ``contention="sim"``. The serial/pipelined
    delta per point is the throughput the 1/latency model left on the
    table.
    """

    tenant: str
    replicas: int
    latency_ns: float
    events_per_sec: float
    tiles_per_replica: int
    tiles_total: int
    plio_ports: int
    schedule: ArraySchedule
    events_per_sec_contended: float = 0.0
    contention: str = "none"
    interval_ns: float = 0.0
    events_per_sec_pipelined: float = 0.0
    events_per_sec_pipelined_contended: float = 0.0

    @property
    def contention_factor(self) -> float:
        if self.events_per_sec <= 0:
            return 1.0
        return self.events_per_sec_contended / self.events_per_sec

    @property
    def pipelined_gain(self) -> float:
        """Contended pipelined rate over contended serial rate (>= 1)."""
        if self.events_per_sec_contended <= 0:
            return 1.0
        return (self.events_per_sec_pipelined_contended
                / self.events_per_sec_contended)

    def as_dict(self) -> dict:
        return {"tenant": self.tenant, "replicas": self.replicas,
                "latency_ns": round(self.latency_ns, 2),
                "interval_ns": round(self.interval_ns, 2),
                "events_per_sec": round(self.events_per_sec, 1),
                "events_per_sec_contended":
                    round(self.events_per_sec_contended, 1),
                "events_per_sec_pipelined":
                    round(self.events_per_sec_pipelined, 1),
                "events_per_sec_pipelined_contended":
                    round(self.events_per_sec_pipelined_contended, 1),
                "pipelined_gain": round(self.pipelined_gain, 4),
                "contention": self.contention,
                "contention_factor": round(self.contention_factor, 4),
                "tiles_per_replica": self.tiles_per_replica,
                "tiles_total": self.tiles_total,
                "plio_ports": self.plio_ports}


def _pipeline_depth_for(design: DSEResult, *, cap: int = 32) -> int:
    """Sim pipeline depth that covers the design's fill (shared formula)."""
    ii = design.interval_cycles or design.latency.total
    return perfmodel.pipeline_fill_depth(design.latency.total, ii, cap=cap)


def throughput_frontier(model: ModelSpec, *,
                        rows: int = aie_arch.ARRAY_ROWS,
                        cols: int = aie_arch.ARRAY_COLS,
                        plio: int = aie_arch.PLIO_PORTS,
                        p: OverheadParams = OVERHEADS,
                        top_k: int = 96,
                        max_replicas_cap: Optional[int] = None,
                        contention: str = "analytic",
                        pipelined: bool = True,
                        sim_events: int = 8,
                        exhaustive: bool = False,
                        registry=None, tracer=None) -> List[ThroughputPoint]:
    """Throughput-aware DSE: sweep the latency/replica-count trade-off.

    For every design on the model's {tiles, latency, II} Pareto frontier,
    pack the maximum replica count the shared array admits; keep the points
    that are Pareto-optimal over {per-event latency, modeled events/sec} —
    where events/sec is the *pipelined contended* figure by default.
    Sorted by ascending latency, so the first entry is the latency winner
    and the last is the throughput winner under the selected model.

    ``contention`` selects how the shim-aware events/sec is priced:
    ``"none"`` keeps the congestion-free assumption, ``"analytic"``
    (default) applies the serialized-ingest fluid model, ``"sim"`` measures
    with the Tier-S discrete-event simulator — the most faithful but
    slowest option. ``pipelined`` selects the ranking basis: the pipelined
    rate ``Σ 1/II`` (default; deep-pipeline fewer-replica designs can now
    beat wide serial packings) or the serial ``Σ 1/latency`` of the
    pre-pipelining model. Every point carries *both* rate families
    regardless of the ranking basis (the non-ranking family is priced
    analytically when ``contention="sim"``).

    ``exhaustive=True`` forwards to :func:`repro_torch.core.dse.search`: the
    replica packing then starts from the *exact* single-instance frontier
    rather than the top-k approximation — slower, but any frontier point
    the top-k DP missed becomes a packing candidate too.
    """
    if contention not in ("none", "analytic", "sim"):
        raise ValueError(f"unknown contention model {contention!r}")
    points: List[ThroughputPoint] = []
    for design in dse.search(model, rows=rows, cols=cols, plio=plio, p=p,
                             top_k=top_k, exhaustive=exhaustive,
                             registry=registry, tracer=tracer):
        sched = pack_max_replicas(design, rows=rows, cols=cols, plio=plio,
                                  cap=max_replicas_cap)
        if sched is None:
            continue
        if contention == "none":
            eps_free = sched.throughput_eps(pipelined=False)
            eps_pipe_free = sched.throughput_eps(pipelined=True)
            eps_cont, eps_pipe_cont = eps_free, eps_pipe_free
        else:
            # one shim-occupancy pass per basis; each report carries both
            # the free and the contended rate for its basis.
            sc = sched.shim_contention(p=p, pipelined=False)
            scp = sched.shim_contention(p=p, pipelined=True)
            eps_free, eps_cont = sc.eps_free, sc.eps_contended
            eps_pipe_free, eps_pipe_cont = scp.eps_free, scp.eps_contended
            if contention == "sim":
                from repro_torch.sim.run import SimConfig, simulate_schedule
                depth = _pipeline_depth_for(design) if pipelined else 1
                events = max(sim_events, 3 * depth)
                # engine="auto": the compiled replay fast path scores the
                # packing bit-exactly (falling back to the DES only when a
                # feature demands it), so the frontier sweep loses the DES
                # construction cost per candidate schedule.
                res = simulate_schedule(
                    sched, p=p, config=SimConfig(events=events, trace=False,
                                                 pipeline_depth=depth),
                    engine="auto")
                measured = (res.steady_throughput_eps() if pipelined
                            else res.throughput_eps())
                if pipelined:
                    eps_pipe_cont = measured
                else:
                    eps_cont = measured
        points.append(ThroughputPoint(
            tenant=model.name, replicas=len(sched.instances),
            latency_ns=design.latency.total_ns,
            events_per_sec=eps_free,
            tiles_per_replica=design.mapping.total_tiles,
            tiles_total=sched.total_tiles,
            plio_ports=sched.plio_ports_used, schedule=sched,
            events_per_sec_contended=eps_cont, contention=contention,
            interval_ns=design.interval_ns or design.latency.total_ns,
            events_per_sec_pipelined=eps_pipe_free,
            events_per_sec_pipelined_contended=eps_pipe_cont))
    # Pareto over {latency, throughput} using the *requested* throughput
    # model: once contention is priced, a packing that stacks fewer boxes
    # per shim column can dominate one with higher congestion-free eps, and
    # once pipelining is priced, a deep-pipeline design with fewer replicas
    # can dominate a wide serial packing.
    if pipelined:
        metric = ((lambda pt: pt.events_per_sec_pipelined)
                  if contention == "none"
                  else (lambda pt: pt.events_per_sec_pipelined_contended))
    else:
        metric = ((lambda pt: pt.events_per_sec) if contention == "none"
                  else (lambda pt: pt.events_per_sec_contended))
    front = dse.pareto_front(points,
                             lambda pt: (pt.latency_ns, -metric(pt)))
    if registry is not None:
        registry.counter("tenancy.frontier.candidates",
                         {"model": model.name}).inc(len(points))
        registry.counter("tenancy.frontier.points",
                         {"model": model.name}).inc(len(front))
    return front


def pack_mix(mix: Sequence[Tuple[str, ModelSpec, int]], *,
             rows: int = aie_arch.ARRAY_ROWS,
             cols: int = aie_arch.ARRAY_COLS,
             plio: int = aie_arch.PLIO_PORTS,
             p: OverheadParams = OVERHEADS,
             top_k: int = 96,
             exhaustive: bool = False,
             registry=None) -> Optional[ArraySchedule]:
    """Schedule a heterogeneous tenant mix ``[(name, model, replicas), ...]``.

    Starts every tenant at its latency-optimal design and, while the mix
    does not fit, backs the largest-footprint tenant off to the next smaller
    design on its {tiles, latency} frontier — trading that tenant's latency
    for fleet feasibility. Returns None when even the smallest designs do
    not fit together. ``registry`` records ``tenancy.pack.attempts`` and
    ``tenancy.pack.backoffs`` counters. ``exhaustive=True`` builds every
    tenant's back-off ladder from the exact frontier (see
    :func:`repro_torch.core.dse.search`), which can surface intermediate rungs
    the top-k DP missed and so soften a back-off step.
    """
    frontiers: List[List[DSEResult]] = []
    for name, model, count in mix:
        fr = dse.search(model, rows=rows, cols=cols, plio=plio, p=p,
                        top_k=top_k, exhaustive=exhaustive,
                        registry=registry)
        if not fr or count < 1:
            return None
        # Back-off ladder: the {tiles, latency} sub-frontier of the grown
        # {tiles, latency, II} frontier — unique tile counts, latency
        # strictly improving with size, so stepping down the ladder always
        # frees tiles. (Same-tile II alternatives matter for throughput
        # ranking, not for fitting a mix.)
        frontiers.append(dse.pareto_front(
            fr, lambda d: (d.mapping.total_tiles, d.latency.total)))
    # index into each tenant's ladder (tiles-ascending; start at the
    # latency-optimal = largest design).
    idx = [len(fr) - 1 for fr in frontiers]
    while True:
        designs: List[Tuple[str, DSEResult]] = []
        for (name, _, count), fr, i in zip(mix, frontiers, idx):
            designs.extend([(name, fr[i])] * count)
        # Place big boxes first for denser packing; pack() names replicas
        # per tenant so the interleaving order does not matter.
        designs.sort(key=lambda d: d[1].mapping.total_tiles, reverse=True)
        if registry is not None:
            registry.counter("tenancy.pack.attempts").inc()
        sched = pack(designs, rows=rows, cols=cols, plio=plio)
        if sched is not None:
            return sched
        # Back off the tenant currently using the most tiles per replica.
        candidates = [k for k in range(len(idx)) if idx[k] > 0]
        if not candidates:
            return None
        k = max(candidates,
                key=lambda k: frontiers[k][idx[k]].mapping.total_tiles)
        idx[k] -= 1
        if registry is not None:
            registry.counter("tenancy.pack.backoffs").inc()


# ---------------------------------------------------------------------------
# Latency under offered load: collapsed-bottleneck queueing on the II
# ---------------------------------------------------------------------------
# Every throughput number above is the *capacity* 1/II — the closed-loop
# rate with an event always waiting. A trigger system is open-loop: events
# arrive on their own clock, and the question the SLO asks is "what latency
# at offered rate λ?", not "what peak rate?". The pipelined instance is a
# tandem of deterministic FIFO stages whose slowest stage is the
# initiation interval, and for such a tandem all queueing collapses onto
# the bottleneck stage: sojourn = congestion-free dataflow latency + the
# waiting accrued at one single-server queue with service derived from
# the II. Two bottleneck disciplines occur in practice:
#
#   * **Single-visit** (a compute tile or inter-layer edge sets the II):
#     the bottleneck is a plain ·/D/1 server with D = II. Under Poisson
#     offered load this is the M/D/1 queue — mean wait ρD / 2(1−ρ) and
#     the exact Crommelin CDF  P(W <= t) = (1−ρ) Σ_{j=0}^{⌊t/D⌋}
#     (λ(jD−t))^j / j! · e^{−λ(jD−t)}  for quantiles.
#   * **Re-entrant** (the shim column sets the II — the common case, since
#     ingest and egress share one capacity-1 DMA per column): every event
#     visits the bottleneck *twice* — t_in cycles at arrival and t_out
#     cycles a dataflow-latency later — so it waits twice, and the second
#     visit samples the server at congestion-biased instants (an egress
#     exists *because* an ingest just got through). Closed-form M/D/1
#     underprices this by up to ~45% at ρ = 0.9; the collapsed model
#     instead solves the two-visit FIFO recursion exactly per arrival
#     sequence (:func:`bottleneck_waits_cycles`), which is deterministic,
#     ~1000x faster than the full DES, and shares none of its code.
#
# The `model.queue.*` drift gate in benchmarks/latency_under_load.py
# feeds ONE seeded arrival trace to both this collapsed model and the
# Tier-S DES and requires the sojourn statistics to agree — a sharp test
# that all queueing really does live at the bottleneck stage.

def md1_mean_wait_s(rate_eps: float, service_s: float) -> float:
    """Mean M/D/1 queueing wait (seconds): ρD / 2(1−ρ); inf at ρ >= 1."""
    if service_s <= 0:
        raise ValueError(f"service time must be > 0, got {service_s}")
    rho = rate_eps * service_s
    if rho <= 0:
        return 0.0
    if rho >= 1.0:
        return math.inf
    return rho * service_s / (2.0 * (1.0 - rho))


def md1_wait_cdf(t_s: float, rate_eps: float, service_s: float) -> float:
    """Exact M/D/1 waiting-time CDF P(W <= t) (Crommelin's formula).

    The sum is alternating with terms up to ~e^{2λt}, so the float path is
    only used while λt stays small; beyond that the terms are evaluated in
    60-digit decimal arithmetic (the sum has at most ⌊t/D⌋+1 terms, so this
    stays cheap). ρ >= 1 returns 0: the queue has no stationary regime.
    """
    if service_s <= 0:
        raise ValueError(f"service time must be > 0, got {service_s}")
    rho = rate_eps * service_s
    if rho >= 1.0:
        return 0.0
    if t_s < 0:
        return 0.0
    if rho <= 0:
        return 1.0
    lam = rate_eps
    k = int(t_s // service_s)
    if lam * t_s <= 30.0 and k <= 200:
        total = math.fsum(
            (lam * (j * service_s - t_s)) ** j / math.factorial(j)
            * math.exp(-lam * (j * service_s - t_s))
            for j in range(k + 1))
        f = (1.0 - rho) * total
    else:
        with decimal.localcontext() as ctx:
            ctx.prec = 60
            lam_d = decimal.Decimal(lam)
            d_d = decimal.Decimal(service_s)
            t_d = decimal.Decimal(t_s)
            total = decimal.Decimal(0)
            fact = decimal.Decimal(1)
            for j in range(k + 1):
                if j:
                    fact *= j
                y = lam_d * (decimal.Decimal(j) * d_d - t_d)   # <= 0
                total += (y ** j) / fact * (-y).exp()
            f = float((1 - decimal.Decimal(rho)) * total)
    return min(1.0, max(0.0, f))


def md1_wait_quantile_s(q: float, rate_eps: float, service_s: float) -> float:
    """q-quantile (seconds) of the M/D/1 wait, by bisection on the CDF.

    P(W = 0) = 1−ρ, so any q <= 1−ρ returns 0 exactly — at low utilization
    even the p99 wait is zero, which is why the latency-under-load curves
    stay flat until the knee.
    """
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    rho = rate_eps * service_s
    if rho <= 0:
        return 0.0
    if rho >= 1.0:
        return math.inf
    if q <= 1.0 - rho + 1e-15:
        return 0.0
    hi = service_s
    for _ in range(200):
        if md1_wait_cdf(hi, rate_eps, service_s) >= q:
            break
        hi *= 2.0
    lo = 0.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if md1_wait_cdf(mid, rate_eps, service_s) >= q:
            hi = mid
        else:
            lo = mid
        if hi - lo <= 1e-6 * service_s:
            break
    return hi


def _lindley_waits(arrivals: Sequence[float], d: float) -> List[float]:
    """Exact FIFO waits at a single-visit deterministic server."""
    waits: List[float] = []
    w = 0.0
    prev = None
    for a in arrivals:
        if prev is not None:
            w = max(0.0, w + d - (a - prev))
        waits.append(w)
        prev = a
    return waits


def _reentrant_waits(arrivals: Sequence[float], t_in: float, t_out: float,
                     gap: float) -> List[float]:
    """Exact total FIFO waits at a two-visit bottleneck server.

    Event k requests ``t_in`` cycles of the server at ``arrivals[k]`` and,
    ``gap`` cycles after that visit completes (the dataflow between ingest
    and egress), ``t_out`` more. Service order is FIFO by request time —
    the discipline of the Tier-S shim resources. Egress requests are
    generated in arrival order and are nondecreasing, so a two-stream
    merge replaces a priority queue. Returns per-event
    ``wait_ingest + wait_egress``.
    """
    n = len(arrivals)
    waits: List[float] = [0.0] * n
    egress: List[Tuple[float, int]] = []   # (request_time, k), FIFO
    eg_head = 0
    free = 0.0
    i = 0
    served = 0
    while served < n:
        take_egress = (eg_head < len(egress)
                       and (i >= n or egress[eg_head][0] <= arrivals[i]))
        if take_egress:
            req, k = egress[eg_head]
            eg_head += 1
            start = max(free, req)
            waits[k] += start - req
            free = start + t_out
            served += 1
        else:
            req = arrivals[i]
            start = max(free, req)
            waits[i] += start - req
            free = start + t_in
            egress.append((free + gap, i))
            i += 1
    return waits


def bottleneck_waits_cycles(arrival_cycles: Sequence[float], *,
                            interval_cycles: float,
                            latency_cycles: float,
                            shim_split: Optional[Tuple[float, float]] = None
                            ) -> List[float]:
    """Collapsed-bottleneck queueing waits (cycles) for one arrival trace.

    The Tier-A answer to "what does this arrival sequence wait?": exact
    FIFO waits at the II-setting stage, single-visit
    (:func:`_lindley_waits`, D = II) unless ``shim_split`` = (t_in, t_out)
    shows the shim is the bottleneck (t_in + t_out >= II), in which case
    the two-visit re-entrant recursion applies with the dataflow gap
    ``latency − II`` between the visits. Per-event sojourn =
    ``latency_cycles + wait``.
    """
    if shim_split is not None:
        t_in, t_out = shim_split
        if t_in + t_out >= interval_cycles - 1e-9:
            gap = max(0.0, latency_cycles - (t_in + t_out))
            return _reentrant_waits(arrival_cycles, t_in, t_out, gap)
    return _lindley_waits(arrival_cycles, interval_cycles)


def summarize_waits(waits: Sequence[float], latency_cycles: float, *,
                    warmup_frac: float = 0.1) -> Dict[str, float]:
    """Sojourn statistics (ns) from collapsed-model waits.

    Mirrors :meth:`repro_torch.sim.run.SimResult.sojourn_summary` — same keys,
    same warmup discard — so the two sides of the `model.queue.*` drift
    comparison are reduced identically.
    """
    s = sorted(latency_cycles + w
               for w in list(waits)[int(len(waits) * warmup_frac):])
    if not s:
        return {"events": 0}

    def pct(q: float) -> float:
        return s[min(len(s) - 1, int(q * len(s)))]
    return {"events": len(s),
            "mean_ns": aie_arch.ns(sum(s) / len(s)),
            "p50_ns": aie_arch.ns(pct(0.50)),
            "p99_ns": aie_arch.ns(pct(0.99)),
            "max_ns": aie_arch.ns(s[-1])}


@dataclasses.dataclass(frozen=True)
class LoadLatency:
    """Analytic sojourn prediction at one offered rate (per replica).

    ``stable=False`` (ρ >= 1) carries infinite waits: the queue grows
    without bound and the deployment needs more replicas, a deeper
    pipeline, or admission control. ``discipline`` records which
    bottleneck model produced the waits: ``"md1"`` (closed-form
    single-visit) or ``"reentrant"`` (two-visit collapsed recursion).
    """

    rate_eps: float            #: offered rate into ONE replica (events/sec)
    utilization: float         #: ρ = rate * II
    service_ns: float          #: bottleneck service per event = II
    base_latency_ns: float     #: congestion-free dataflow latency
    wait_mean_ns: float
    wait_p50_ns: float
    wait_p99_ns: float
    stable: bool
    discipline: str = "md1"

    @property
    def sojourn_mean_ns(self) -> float:
        return self.base_latency_ns + self.wait_mean_ns

    @property
    def sojourn_p99_ns(self) -> float:
        return self.base_latency_ns + self.wait_p99_ns

    def as_dict(self) -> dict:
        return {"rate_eps": self.rate_eps,
                "utilization": round(self.utilization, 6),
                "service_ns": round(self.service_ns, 3),
                "base_latency_ns": round(self.base_latency_ns, 3),
                "wait_mean_ns": round(self.wait_mean_ns, 3),
                "wait_p50_ns": round(self.wait_p50_ns, 3),
                "wait_p99_ns": round(self.wait_p99_ns, 3),
                "sojourn_mean_ns": round(self.sojourn_mean_ns, 3),
                "sojourn_p99_ns": round(self.sojourn_p99_ns, 3),
                "stable": self.stable,
                "discipline": self.discipline}


def shim_split_cycles(placement: Placement, *,
                      p: OverheadParams = OVERHEADS
                      ) -> Tuple[float, float]:
    """(t_in, t_out) per-column shim cycles of a placement — the visit
    durations of the re-entrant bottleneck model."""
    _, t_in, t_out = shim_transfer_cycles(placement, p=p)
    return t_in, t_out


def latency_under_load(rate_eps: float, *, interval_ns: float,
                       latency_ns: float, replicas: int = 1,
                       shim_split_ns: Optional[Tuple[float, float]] = None,
                       mc_events: int = 60_000,
                       seed: int = 0) -> LoadLatency:
    """Analytic latency at offered Poisson rate (collapsed bottleneck).

    ``rate_eps`` is the tenant's total offered rate; with ``replicas`` > 1
    it is split evenly (round-robin dispatch — each replica's stream is
    then slightly smoother than Poisson, so the single-replica wait is a
    mild upper bound). Without ``shim_split_ns`` the bottleneck is
    single-visit and the waits are closed-form M/D/1; with it, and when
    the shim is the II-setting stage, the two-visit recursion runs on a
    seeded ``mc_events``-long Poisson trace (deterministic per seed).
    """
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    service_s = interval_ns * 1e-9
    per = rate_eps / replicas
    rho = per * service_s
    reentrant = (shim_split_ns is not None
                 and sum(shim_split_ns) >= interval_ns - 1e-9)
    if rho >= 1.0:
        return LoadLatency(rate_eps=per, utilization=rho,
                           service_ns=interval_ns,
                           base_latency_ns=latency_ns,
                           wait_mean_ns=math.inf, wait_p50_ns=math.inf,
                           wait_p99_ns=math.inf, stable=False,
                           discipline="reentrant" if reentrant else "md1")
    if not reentrant:
        return LoadLatency(
            rate_eps=per, utilization=rho, service_ns=interval_ns,
            base_latency_ns=latency_ns,
            wait_mean_ns=md1_mean_wait_s(per, service_s) * 1e9,
            wait_p50_ns=md1_wait_quantile_s(0.50, per, service_s) * 1e9,
            wait_p99_ns=md1_wait_quantile_s(0.99, per, service_s) * 1e9,
            stable=True, discipline="md1")
    import random as _random
    rng = _random.Random(seed)
    t = 0.0
    rate_per_ns = per * 1e-9
    arrivals = [t := t + rng.expovariate(rate_per_ns)
                for _ in range(mc_events)]
    t_in, t_out = shim_split_ns
    gap = max(0.0, latency_ns - (t_in + t_out))
    waits = _reentrant_waits(arrivals, t_in, t_out, gap)
    cut = sorted(waits[int(len(waits) * 0.1):])

    def pct(q: float) -> float:
        return cut[min(len(cut) - 1, int(q * len(cut)))]
    return LoadLatency(
        rate_eps=per, utilization=rho, service_ns=interval_ns,
        base_latency_ns=latency_ns,
        wait_mean_ns=sum(cut) / len(cut),
        wait_p50_ns=pct(0.50), wait_p99_ns=pct(0.99),
        stable=True, discipline="reentrant")


def max_rate_for_slo(p99_budget_ns: float, *, interval_ns: float,
                     latency_ns: float, replicas: int = 1,
                     q: float = 0.99,
                     shim_split_ns: Optional[Tuple[float, float]] = None,
                     mc_events: int = 20_000, seed: int = 0) -> float:
    """Largest total offered rate whose q-quantile sojourn meets the budget.

    Inverts :func:`latency_under_load` by bisection (the q-quantile wait
    is monotone in the rate). Returns 0.0 when the budget is below the
    congestion-free latency — no admission rate can meet it — and
    approaches ``replicas / II`` as the budget loosens. The re-entrant
    path uses a shorter seeded trace per probe (``mc_events``), keeping
    the inversion deterministic.
    """
    if p99_budget_ns < latency_ns:
        return 0.0
    budget_wait_ns = p99_budget_ns - latency_ns

    def wait_at(rate: float) -> float:
        ll = latency_under_load(rate, interval_ns=interval_ns,
                                latency_ns=latency_ns,
                                shim_split_ns=shim_split_ns,
                                mc_events=mc_events, seed=seed)
        return (ll.wait_p99_ns if abs(q - 0.99) < 1e-12
                else (ll.wait_p50_ns if abs(q - 0.50) < 1e-12
                      else md1_wait_quantile_s(
                          q, ll.rate_eps, interval_ns * 1e-9) * 1e9))

    lo, hi = 0.0, 1e9 / interval_ns
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if wait_at(mid) <= budget_wait_ns:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-5 * hi:
            break
    return lo * replicas


def tenant_latency_under_load(schedule: ArraySchedule, tenant: str,
                              rate_eps: float, *,
                              contended: bool = True,
                              p: OverheadParams = OVERHEADS) -> LoadLatency:
    """Per-tenant load curve on a packed schedule.

    Splits the tenant's offered rate evenly over its replicas and prices
    each replica's service time as its (optionally shim-throttled)
    initiation interval; heterogeneous throttles are collapsed to the
    worst replica's interval, so the prediction is conservative. The shim
    visit split is taken from the first replica's placement (replicas of
    one tenant share a design).
    """
    insts = schedule.per_tenant().get(tenant)
    if not insts:
        raise KeyError(f"tenant {tenant!r} not in schedule")
    intervals = [i.interval_ns for i in insts]
    factor = 1.0
    if contended:
        sc = schedule.shim_contention(pipelined=True, p=p)
        by_id = {id(i): f for i, f in zip(schedule.instances, sc.factors)}
        factor = min(max(by_id[id(i)], 1e-12) for i in insts)
        intervals = [i.interval_ns / max(by_id[id(i)], 1e-12)
                     for i in insts]
    t_in, t_out = shim_split_cycles(insts[0].placement, p=p)
    split_ns = (aie_arch.ns(t_in) / factor, aie_arch.ns(t_out) / factor)
    return latency_under_load(rate_eps,
                              interval_ns=max(intervals),
                              latency_ns=max(i.latency_ns for i in insts),
                              replicas=len(insts),
                              shim_split_ns=split_ns)
