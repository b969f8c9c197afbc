"""μ-ORCA overhead-aware performance model (paper §5.1, Eqs. 1-6).

Two modes:

* **ideal** — all overhead constants zeroed; pure bandwidth/MAC arithmetic.
  Reproduces the paper's §3.1 motivating example exactly (288 vs 48 cycles).
* **calibrated** — the paper's Eq. (1)-(6) with overhead constants fitted to
  the paper's measured Table 2 / Table 4 numbers (:func:`calibrate`).

Ground-truth measurement tables from the paper are embedded here; they are
the calibration + validation data and the reference for the Fig. 9 model-error
reproduction.

Scalar <-> batched contract
---------------------------

This module is the scalar *reference*; :mod:`repro_torch.core.perfmodel_batched`
holds vectorized twins (``single_aie_cycles`` -> ``single_aie_cycles_v``,
``end_to_end_cycles`` -> ``end_to_end_cycles_v``, ...) that score ``[N]``
candidate designs per call for the exhaustive DSE and the throughput
benchmarks. The contract is **bit-identical results**, not approximate
agreement: the twins replicate this module's exact operation order
(integer ceil-divisions instead of float ``math.ceil``, left-to-right
summation instead of numpy's pairwise reduction), and the parity tests in
``tests/test_perfmodel_batched.py`` assert ``==`` on every Table 2 shape
and every DSE frontier design. When editing a formula here, mirror the
change in the twin — the tests (and the calibration gate in CI) catch any
divergence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import aie_arch
from .aie_arch import OverheadParams, OVERHEADS
from .layerspec import LayerSpec, ModelSpec
from .mapping import Mapping, ModelMapping, cascade_compatible
from .placement import Placement, Rect, east_adjacent, max_manhattan

# ---------------------------------------------------------------------------
# Paper measurements (ground truth)
# ---------------------------------------------------------------------------

#: Table 2 — single-AIE computation time in ns (DMA load/store omitted).
#: shape -> (GAMA, AIE4ML(+BR), uORCA, uORCA(+BR))
TABLE2_NS: Dict[Tuple[int, int, int], Tuple[float, float, float, float]] = {
    (16, 16, 16): (32.0, 34.4, 31.2, 34.4),
    (32, 32, 32): (184.0, 194.4, 129.6, 184.0),
    (64, 64, 64): (897.6, 1109.6, 868.0, 967.2),
    (8, 32, 32): (63.2, 82.4, 45.6, 56.0),
    (8, 64, 64): (124.8, 167.2, 123.2, 136.0),
    (8, 128, 128): (438.4, 525.6, 438.4, 525.6),
}

#: Table 4 — global aggregation latency in ns: (M, F, #AIE) -> (baseline, ours)
TABLE4_NS: Dict[Tuple[int, int, int], Tuple[float, float]] = {
    (32, 32, 4): (373.0, 66.0),
    (32, 64, 4): (760.0, 72.0),
    (64, 32, 8): (397.0, 139.0),
    (64, 64, 8): (834.0, 145.0),
}


def _blk(dtype: str) -> Tuple[int, int, int]:
    return aie_arch.BLOCK_SHAPES[dtype]


# ---------------------------------------------------------------------------
# Eq. (1)-(2): single-AIE kernel latency
# ---------------------------------------------------------------------------

def j_loops(H1: int, W2: int, dtype: str = "int8") -> int:
    bm, _, bn = _blk(dtype)
    return max(1, (H1 * W2) // (4 * bm * bn))


def l_j_cycles(W1: int, *, cascaded: bool = False,
               p: OverheadParams = OVERHEADS, dtype: str = "int8",
               ideal: bool = False) -> float:
    """Eq. (2)/(3): latency of one j loop."""
    _, bk, _ = _blk(dtype)
    base = 4.0 * W1 / bk
    if ideal:
        return base
    lj = base + p.l_epi
    if cascaded:
        lj += p.l_cas
    return lj


def br_overhead(H1: int, W2: int, p: OverheadParams = OVERHEADS) -> float:
    """Fixed bias+ReLU+requant epilogue cost (calibrated to Table 2 +BR)."""
    return max(0.0, p.br_w2 * W2 + p.br_h1 * H1 + p.br_fixed)


def single_aie_cycles(H1: int, W1: int, W2: int, *, bias_relu: bool = False,
                      store_local: bool = True, p: OverheadParams = OVERHEADS,
                      dtype: str = "int8", ideal: bool = False) -> float:
    """Eq. (1): L_AIE = (H1*W2 / (4*B_M*B_N)) * L_j + L_o.

    ``store_local=False`` models the cascade-output case where the store
    instructions are never issued (paper §5.1.1: "when using cascade
    communication, the results will not store to the local memory").
    """
    njl = j_loops(H1, W2, dtype)
    lj = l_j_cycles(W1, p=p, dtype=dtype, ideal=ideal)
    if ideal:
        return njl * lj
    lo = p.l_o
    if store_local:
        lo += p.l_o_store_dma * (H1 * W2)   # INT8: one byte per output element
    if bias_relu:
        lo += br_overhead(H1, W2, p)
    return njl * lj + lo


# ---------------------------------------------------------------------------
# Eq. (3)-(4): AIE-array (one layer) computation latency
# ---------------------------------------------------------------------------

def layer_comp_cycles(m: Mapping, *, out_cascade: bool,
                      p: OverheadParams = OVERHEADS,
                      ideal: bool = False) -> float:
    """Eq. (4): L_comp = (njl + B - 1) * max_a(L_j^a) + L_o.

    The rightmost (a = B-1) AIE additionally runs the bias/ReLU epilogue
    (paper §4.3.2), so it owns the max when bias_relu is set.
    """
    l = m.layer
    if l.kind == "agg":
        return agg_ours_cycles(m.A, m.H1, m.W2, p=p, ideal=ideal)
    njl = m.j_loops
    cascaded = m.B > 1
    lj_max = l_j_cycles(m.W1, cascaded=cascaded, p=p, dtype=m.dtype,
                        ideal=ideal)
    if ideal:
        return (njl + m.B - 1) * lj_max
    lo = p.l_o
    if not out_cascade:
        lo += p.l_o_store_dma * (m.H1 * m.W2)
    if l.bias or l.relu:
        # Only the rightmost column runs the fused bias/ReLU epilogue
        # (paper §4.3.2); it is the critical-path AIE.
        lo += br_overhead(m.H1, m.W2, p)
    return (njl + m.B - 1) * lj_max + lo


# ---------------------------------------------------------------------------
# Per-tile occupancy decomposition of Eq. (4) (consumed by the Tier-S simulator)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerOccupancy:
    """Eq. (4) decomposed into per-tile busy intervals.

    ``spans`` holds one ``(local_row, local_col, start, dur)`` tuple per tile
    of the layer's rectangle, with ``start`` relative to the layer's launch.
    The makespan (``max(start + dur)``) equals :func:`layer_comp_cycles` for
    the same arguments — the discrete-event simulator schedules these spans
    on physical tile resources and inherits the Tier-A calibration exactly.
    """

    spans: Tuple[Tuple[int, int, float, float], ...]
    lj: float                  #: per-j-loop cycles on the critical column
    njl: int                   #: j loops per kernel

    @property
    def makespan(self) -> float:
        return max(s + d for _, _, s, d in self.spans)


def layer_occupancy(m: Mapping, *, out_cascade: bool,
                    p: OverheadParams = OVERHEADS,
                    ideal: bool = False) -> LayerOccupancy:
    """Per-tile busy intervals of one layer (Eq. 4 / Table 4 decomposition).

    MM layers: every row of B tiles pipelines along the intra-layer cascade;
    column b starts ``b * L_j`` after launch (the FIFO fill skew — depth-4
    512-bit FIFOs plus the calibrated ``l_cas`` back-pressure stall are what
    make L_j the per-column period), and the rightmost column additionally
    runs the non-pipelined L_o epilogue (store + bias/ReLU).

    Aggregation layers: the column of A tiles chains via shared memory with a
    per-AIE handoff of ``agg_per_aie`` cycles (Table 4 calibration).
    """
    l = m.layer
    spans: List[Tuple[int, int, float, float]] = []
    if l.kind == "agg":
        total = agg_ours_cycles(m.A, m.H1, m.W2, p=p, ideal=ideal)
        bm, bk, bn = _blk(m.dtype)
        vmacs = math.ceil(m.H1 / bk) * math.ceil(m.W2 / bn)
        dur = total if ideal else p.agg_fixed + p.agg_per_aie + vmacs
        if ideal or dur <= 0 or m.rows == 1:
            spans = [(r, 0, 0.0, total) for r in range(m.rows)]
        else:
            spans = [(r, 0, r * p.agg_per_aie, dur) for r in range(m.rows)]
        return LayerOccupancy(spans=tuple(spans), lj=dur, njl=1)

    njl = m.j_loops
    cascaded = m.B > 1
    lj = l_j_cycles(m.W1, cascaded=cascaded, p=p, dtype=m.dtype, ideal=ideal)
    lo = 0.0
    if not ideal:
        lo = p.l_o
        if not out_cascade:
            lo += p.l_o_store_dma * (m.H1 * m.W2)
        if l.bias or l.relu:
            lo += br_overhead(m.H1, m.W2, p)
    for lr in range(m.rows):
        for lc in range(m.cols):
            dur = njl * lj + (lo if lc == m.cols - 1 else 0.0)
            spans.append((lr, lc, lc * lj, dur))
    return LayerOccupancy(spans=tuple(spans), lj=lj, njl=njl)


# ---------------------------------------------------------------------------
# Eq. (5)-(6): inter-layer communication latency
# ---------------------------------------------------------------------------

def dma_comm_cycles(data_bytes: int, manhattan: int, *, n_streams: int = 1,
                    p: OverheadParams = OVERHEADS, ideal: bool = False) -> float:
    """Eq. (5): L_comm^DMA = L_init + bits/32 + 4*D.

    ``n_streams`` DMA channels move disjoint pieces concurrently (one per
    destination buffer); the longest stream bounds latency, as does the
    longest Manhattan distance (paper §5.1.3).
    """
    xfer = math.ceil(data_bytes * 8 / (aie_arch.DMA_BITS_PER_CYCLE * n_streams))
    if ideal:
        return xfer
    return p.l_init + xfer + p.dma_hop * manhattan


def cascade_comm_cycles(p: OverheadParams = OVERHEADS,
                        ideal: bool = False) -> float:
    """Eq. (6): constant gap O_cas — everything else overlaps (paper §4.2.3)."""
    return 0.0 if ideal else p.o_cas


def sharedmem_comm_cycles(data_bytes: int, *, p: OverheadParams = OVERHEADS,
                          ideal: bool = False) -> float:
    """Shared-local-memory connection: 256 b/cyc + lock sync (Fig. 1b)."""
    xfer = math.ceil(data_bytes * 8 / aie_arch.SHAREDMEM_BITS_PER_CYCLE)
    return xfer if ideal else p.l_init * 0.5 + xfer


def plio_cycles(data_bytes: int, ports: int, *, p: OverheadParams = OVERHEADS,
                ideal: bool = False) -> float:
    """PL <-> AIE streaming for first-layer load / last-layer store."""
    ports = max(1, ports)
    xfer = math.ceil(data_bytes * 8 / (p.plio_bits_per_cycle * ports))
    return xfer if ideal else p.plio_init + xfer


# ---------------------------------------------------------------------------
# Global aggregation layers (paper §4.3.1, Table 4)
# ---------------------------------------------------------------------------

def agg_ours_cycles(A: int, H1: int, W2: int, *, p: OverheadParams = OVERHEADS,
                    ideal: bool = False, dtype: str = "int8") -> float:
    """μ-ORCA MAC-based aggregation: reduce H1 x W2 per AIE with VMACs.

    One VMAC reduces a (B_K x B_N) slab (ones-row LHS trick); latency is
    dominated by fixed kernel overhead plus per-AIE chain handoff
    (Table 4: latency grows with #AIE, mildly with the per-AIE matrix).
    """
    bm, bk, bn = _blk(dtype)
    vmacs = math.ceil(H1 / bk) * math.ceil(W2 / bn)
    if ideal:
        return float(vmacs)
    return p.agg_fixed + p.agg_per_aie * A + vmacs


def agg_baseline_cycles(A: int, H1: int, W2: int, *,
                        p: OverheadParams = OVERHEADS) -> float:
    """In-house baseline (paper §6.5): extract()/aie::add/insert() per row —
    vector moves on the critical path, cost ~ per-element."""
    return p.agg_base_fixed + p.agg_base_per_aie * A + p.agg_base_per_elem * (H1 * W2)


# ---------------------------------------------------------------------------
# Per-edge communication decomposition (shared by Tier-A, Tier-S, pipelining)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeComm:
    """One inter-layer edge of a placed design, fully priced.

    ``kind`` is ``'cascade'`` | ``'sharedmem'`` | ``'dma'``; ``cycles`` is the
    Eq. (5)/(6) latency of moving one event's activation across the edge, and
    ``data_bytes``/``n_streams`` are what the byte-conservation invariants and
    the DMA striping model consume. The edge is also a pipeline *stage*: it
    is occupied ``cycles`` per event, independent of the other stages.
    """

    kind: str
    cycles: float
    data_bytes: int
    n_streams: int


def edge_comms(placement: Placement, *, p: OverheadParams = OVERHEADS,
               ideal: bool = False) -> Tuple[EdgeComm, ...]:
    """Price every inter-layer edge of a placement (Eq. 5/6 + §4.3.1).

    Single source of truth for the edge kind/cost decision: consumed by
    :func:`end_to_end_cycles` (serial sum), :func:`pipeline_stages` (stage
    occupancy), and the Tier-S task-graph builder (the Tier-S simulator),
    which previously duplicated this logic.
    """
    maps = placement.model_mapping.mappings
    links = placement.cascade_links()
    dists = placement.dma_distances()
    edges: List[EdgeComm] = []
    for i in range(len(maps) - 1):
        nxt = maps[i + 1]
        data = maps[i].layer.out_bytes
        if links[i]:
            # Aggregation consumers hand off via shared local memory; the
            # per-AIE cost is folded into agg_ours_cycles, so either way the
            # edge itself adds only the constant lock-free gap (Eq. 6).
            kind = "sharedmem" if nxt.layer.kind == "agg" else "cascade"
            edges.append(EdgeComm(kind=kind,
                                  cycles=cascade_comm_cycles(p=p, ideal=ideal),
                                  data_bytes=data, n_streams=1))
        else:
            # Direct DMA between layers: the consumer needs the producer's
            # output partition it reads; duplicated pieces multicast free.
            n_streams = max(1, min(maps[i].A * maps[i].C, nxt.A * nxt.B))
            edges.append(EdgeComm(
                kind="dma",
                cycles=dma_comm_cycles(math.ceil(data / n_streams) * n_streams,
                                       dists[i], n_streams=n_streams, p=p,
                                       ideal=ideal),
                data_bytes=data, n_streams=n_streams))
    return tuple(edges)


def shim_stage_cycles(placement: Placement, *, p: OverheadParams = OVERHEADS,
                      streams_per_col: int = aie_arch.SHIM_STREAMS_PER_COL,
                      ideal: bool = False
                      ) -> Tuple[Tuple[int, ...], float, float]:
    """Per-column PLIO occupancy of one instance, per event.

    Returns ``(columns, t_in, t_out)``: the shim columns under the
    instance's bounding box, and the cycles each column is busy for one
    event's ingest / egress. Transfers stripe across the footprint columns
    in parallel, but the effective port count is capped by the shim
    bandwidth (``streams_per_col`` per column) — a design whose PLIO demand
    exceeds its box width transfers slower than the uncapped Tier-A
    ``plio_cycles`` term assumes. When uncapped, ``t_in``/``t_out`` equal
    the analytic PLIO terms exactly.
    """
    maps = placement.model_mapping.mappings
    first, last = maps[0], maps[-1]
    cols = placement.shim_columns()
    eff_in = min(first.A * first.B, streams_per_col * len(cols))
    eff_out = min(last.A * last.C, streams_per_col * len(cols))
    t_in = plio_cycles(first.layer.in_bytes, eff_in, p=p, ideal=ideal)
    t_out = plio_cycles(last.layer.out_bytes, eff_out, p=p, ideal=ideal)
    return cols, t_in, t_out


# ---------------------------------------------------------------------------
# Pipelined execution: stage decomposition + initiation interval
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineStage:
    """One overlap-able stage of the per-instance schedule.

    ``cycles`` is the stage's per-event occupancy of its busiest resource —
    the time the stage needs *per event*, not the time an event spends in
    it. Stages operate on different events concurrently (cascade-chained
    columns keep computing layer ``i`` for event ``k+1`` while layer
    ``i+1`` consumes event ``k``), so the steady-state initiation interval
    of the instance is the max, not the sum, of the stage occupancies.
    """

    name: str
    kind: str          #: 'shim' | 'comp' | 'comm'
    cycles: float


@dataclasses.dataclass(frozen=True)
class PipelineBreakdown:
    """The per-instance schedule decomposed into overlap-able stages.

    The serial latency of :func:`end_to_end_cycles` is (up to the shim
    bandwidth cap) the *sum* of these stages; the pipelined initiation
    interval is their *max*. ``interval <= latency`` always — a design is
    never slower pipelined — and the gap between the two is exactly the
    throughput the serial ``1/latency`` model leaves on the table.
    """

    stages: Tuple[PipelineStage, ...]

    @property
    def interval(self) -> float:
        """Congestion-free initiation interval in cycles (bottleneck stage)."""
        return max(s.cycles for s in self.stages)

    @property
    def bottleneck(self) -> PipelineStage:
        return max(self.stages, key=lambda s: s.cycles)

    def as_dict(self) -> dict:
        return {"interval_cycles": self.interval,
                "interval_ns": aie_arch.ns(self.interval),
                "bottleneck": self.bottleneck.name,
                "stages": [{"name": s.name, "kind": s.kind,
                            "cycles": s.cycles} for s in self.stages]}


def pipeline_stages(placement: Placement, *, p: OverheadParams = OVERHEADS,
                    ideal: bool = False, include_plio: bool = True,
                    streams_per_col: int = aie_arch.SHIM_STREAMS_PER_COL
                    ) -> PipelineBreakdown:
    """Decompose one instance's schedule into overlap-able pipeline stages.

    Three stage classes, mirroring the resources the Tier-S simulator
    serializes on:

      * **shim** — the PLIO ingest + egress DMA of the columns under the
        bounding box. Ingest of event ``k+1`` and egress of event ``k``
        share the same column DMA, so the stage occupancy per event is
        ``t_in + t_out`` (per column; columns stripe in parallel).
      * **comp, one per layer** — the busiest tile of the layer. Within a
        layer the B cascade columns are skewed by ``L_j`` (FIFO fill), but
        each *tile* is only busy ``njl * L_j (+ L_o on the epilogue
        column)`` per event, so a new event can enter the layer every
        bottleneck-tile occupancy even though the layer's makespan is the
        longer Eq. (4) value.
      * **comm, one per inter-layer edge** — the cascade gap / shared-mem
        handoff / DMA route, occupied ``EdgeComm.cycles`` per event.
    """
    maps = placement.model_mapping.mappings
    links = placement.cascade_links()
    stages: List[PipelineStage] = []
    if include_plio:
        _, t_in, t_out = shim_stage_cycles(placement, p=p,
                                           streams_per_col=streams_per_col,
                                           ideal=ideal)
        stages.append(PipelineStage(name="shim", kind="shim",
                                    cycles=t_in + t_out))
    for i, m in enumerate(maps):
        out_cas = i < len(links) and links[i]
        occ = layer_occupancy(m, out_cascade=out_cas, p=p, ideal=ideal)
        busy = max(d for _, _, _, d in occ.spans)
        stages.append(PipelineStage(name=f"L{i}:{m.layer.name or m.layer.kind}",
                                    kind="comp", cycles=busy))
    for i, e in enumerate(edge_comms(placement, p=p, ideal=ideal)):
        stages.append(PipelineStage(name=f"L{i}>L{i + 1}:{e.kind}",
                                    kind="comm", cycles=e.cycles))
    return PipelineBreakdown(stages=tuple(stages))


def initiation_interval_cycles(placement: Placement, *,
                               p: OverheadParams = OVERHEADS,
                               ideal: bool = False, include_plio: bool = True,
                               streams_per_col: int =
                               aie_arch.SHIM_STREAMS_PER_COL) -> float:
    """Congestion-free initiation interval of a placed design, in cycles.

    The bottleneck stage of :func:`pipeline_stages`: a pipelined instance
    can accept (and complete) one event every II cycles in steady state,
    even though each individual event still takes the full end-to-end
    latency to flow through. II is always <= the Tier-S *simulated* serial
    latency (every stage is part of that serial schedule). It can exceed
    the analytic :func:`end_to_end_cycles` total only when the shim
    bandwidth cap binds (PLIO stream demand > ``streams_per_col`` x box
    width): there the Eq. (1)-(6) PLIO terms are priced uncapped and the
    analytic latency is itself optimistic — the capped II is the honest
    sustained figure. The Tier-S simulator's single-tenant steady-state
    rate converges to ``1 / II`` once ``pipeline_depth`` covers the fill.
    """
    return pipeline_stages(placement, p=p, ideal=ideal,
                           include_plio=include_plio,
                           streams_per_col=streams_per_col).interval


def pipeline_fill_depth(latency_cycles: float, interval_cycles: float, *,
                        slack: int = 1, cap: Optional[int] = None) -> int:
    """Admission depth that keeps the bottleneck stage saturated.

    ``ceil(latency / II) + slack`` events must be in flight before the
    bottleneck stage stops draining between events; anything deeper only
    adds queueing. Single source of the formula for the Tier-S drivers,
    the frontier's sim pricing, and the sim-vs-model agreement gate.
    """
    depth = math.ceil(latency_cycles / max(interval_cycles, 1e-9)) + slack
    if cap is not None:
        depth = min(depth, cap)
    return max(2, depth)


# ---------------------------------------------------------------------------
# End-to-end model latency (§5.1: total = sum of L_comp and L_comm)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LatencyBreakdown:
    plio_in: float
    comp: List[float]
    comm: List[float]            # one entry per inter-layer edge
    comm_kind: List[str]         # 'cascade' | 'dma' | 'sharedmem'
    plio_out: float

    @property
    def total(self) -> float:
        return self.plio_in + sum(self.comp) + sum(self.comm) + self.plio_out

    @property
    def total_ns(self) -> float:
        return aie_arch.ns(self.total)


def end_to_end_cycles(placement: Placement, *, p: OverheadParams = OVERHEADS,
                      ideal: bool = False,
                      include_plio: bool = True) -> LatencyBreakdown:
    """Paper §5.1: model latency = Σ L_comp + Σ L_comm (+ PLIO in/out).

    Edge communication kind is decided by the placement's cascade links;
    aggregation layers consume via shared local memory (§4.3.1).
    """
    mm = placement.model_mapping
    maps = mm.mappings
    links = placement.cascade_links()

    first, last = maps[0], maps[-1]
    plio_in = (plio_cycles(first.layer.in_bytes, first.A * first.B, p=p,
                           ideal=ideal) if include_plio else 0.0)
    plio_out = (plio_cycles(last.layer.out_bytes, last.A * last.C, p=p,
                            ideal=ideal) if include_plio else 0.0)

    comp: List[float] = []
    for i, m in enumerate(maps):
        out_cas = i < len(links) and links[i]
        comp.append(layer_comp_cycles(m, out_cascade=out_cas, p=p, ideal=ideal))
    edges = edge_comms(placement, p=p, ideal=ideal)
    return LatencyBreakdown(plio_in=plio_in, comp=comp,
                            comm=[e.cycles for e in edges],
                            comm_kind=[e.kind for e in edges],
                            plio_out=plio_out)


# ---------------------------------------------------------------------------
# Latency blame: Eq. (1)-(6) re-summed per overhead category (Tier-A side of
# the critical-path attribution layer; Tier-S twin in the profiler)
# ---------------------------------------------------------------------------

#: The paper's overhead taxonomy, as blame categories. Values are *signed*
#: cycles: ``agg_fixed`` is a fitted negative constant, so an aggregation
#: layer's ``prologue`` share can be below zero — the decomposition is a
#: signed re-summation of Eq. (1)-(6), not a partition into positive parts.
#: The Tier-S profiler adds the emergent wait categories on top
#: (``queue_wait``, ``xtenant:<label>``, ``admission_wait``), which exist
#: only under contention and are therefore absent from the analytic side.
BLAME_CATEGORIES: Tuple[str, ...] = (
    "shim_ingest", "shim_egress", "compute", "prologue", "sync", "store",
    "comm_cascade", "comm_dma", "comm_sharedmem")

#: Which OverheadParams constants a blame category's cycles scale with —
#: the validation hook for the profiler's ``whatif``: projecting
#: ``whatif(cat, f)`` on the recorded DAG must agree with re-simulating
#: under ``scale_overheads(p, cat, f)``. Only the categories that are
#: *linear* in their constants are listed (``store`` is excluded: the
#: bias/ReLU term is clamped at zero, so scaling its constants is not
#: guaranteed to scale the cost).
BLAME_PARAM_KNOBS: Dict[str, Tuple[str, ...]] = {
    "prologue": ("l_epi", "l_o", "agg_fixed"),
    "sync": ("l_cas", "agg_per_aie"),
}


def scale_overheads(p: OverheadParams, category: str,
                    factor: float) -> OverheadParams:
    """Counterfactual params with one blame category's constants scaled."""
    knobs = BLAME_PARAM_KNOBS.get(category)
    if knobs is None:
        raise ValueError(
            f"no parameter knobs for category {category!r} "
            f"(choices: {sorted(BLAME_PARAM_KNOBS)})")
    return dataclasses.replace(
        p, **{k: getattr(p, k) * factor for k in knobs})


def _add_blame(blame: Dict[str, float], cat: str, cycles: float) -> None:
    if cycles:
        blame[cat] = blame.get(cat, 0.0) + cycles


def mm_loop_blame(W1: int, *, n_loops: float, cascaded: bool,
                  p: OverheadParams = OVERHEADS, dtype: str = "int8",
                  ideal: bool = False) -> Dict[str, float]:
    """Blame of ``n_loops`` j-loop iterations (Eq. 2/3 split per term).

    The values sum to ``n_loops * l_j_cycles(...)`` (up to float
    association): ``compute`` is the ideal MAC time, ``prologue`` the VLIW
    epilogue stall ``l_epi``, ``sync`` the cascade back-pressure ``l_cas``.
    """
    _, bk, _ = _blk(dtype)
    out = {"compute": n_loops * (4.0 * W1 / bk)}
    if not ideal:
        out["prologue"] = n_loops * p.l_epi
        if cascaded:
            out["sync"] = n_loops * p.l_cas
    return out


def mm_epilogue_blame(H1: int, W2: int, *, out_cascade: bool, bias_relu: bool,
                      p: OverheadParams = OVERHEADS,
                      ideal: bool = False) -> Dict[str, float]:
    """Blame of the non-pipelined L_o epilogue of Eq. (1)/(4):
    ``prologue`` = launch/sync constant, ``store`` = local-store DMA +
    the fused bias/ReLU/requant tail."""
    if ideal:
        return {}
    out = {"prologue": p.l_o}
    store = 0.0
    if not out_cascade:
        store += p.l_o_store_dma * (H1 * W2)
    if bias_relu:
        store += br_overhead(H1, W2, p)
    if store:
        out["store"] = store
    return out


def agg_blame(A: int, H1: int, W2: int, *, p: OverheadParams = OVERHEADS,
              ideal: bool = False, dtype: str = "int8") -> Dict[str, float]:
    """Blame of an A-AIE aggregation chain (§4.3.1): ``compute`` = VMACs,
    ``sync`` = per-AIE shared-memory handoffs, ``prologue`` = the fitted
    fixed kernel constant (negative — see :data:`BLAME_CATEGORIES`)."""
    bm, bk, bn = _blk(dtype)
    vmacs = float(math.ceil(H1 / bk) * math.ceil(W2 / bn))
    if ideal:
        return {"compute": vmacs}
    return {"compute": vmacs, "prologue": p.agg_fixed,
            "sync": p.agg_per_aie * A}


def layer_blame(m: Mapping, *, out_cascade: bool,
                p: OverheadParams = OVERHEADS,
                ideal: bool = False) -> Dict[str, float]:
    """Eq. (4) layer cost split into blame categories. The values sum to
    :func:`layer_comp_cycles` for the same arguments (up to float
    association — the blame multiplies each term out separately)."""
    l = m.layer
    if l.kind == "agg":
        return agg_blame(m.A, m.H1, m.W2, p=p, ideal=ideal, dtype=m.dtype)
    blame = mm_loop_blame(m.W1, n_loops=float(m.j_loops + m.B - 1),
                          cascaded=m.B > 1, p=p, dtype=m.dtype, ideal=ideal)
    for k, v in mm_epilogue_blame(m.H1, m.W2, out_cascade=out_cascade,
                                  bias_relu=bool(l.bias or l.relu), p=p,
                                  ideal=ideal).items():
        _add_blame(blame, k, v)
    return blame


def latency_blame(placement: Placement, *, p: OverheadParams = OVERHEADS,
                  ideal: bool = False,
                  include_plio: bool = True) -> Dict[str, float]:
    """Closed-form latency attribution from the Eq. (1)-(6) stage terms.

    Returns signed cycles per :data:`BLAME_CATEGORIES` entry (every
    category present, zero when unused), summing to
    ``end_to_end_cycles(...).total`` up to float association. This is the
    Tier-A side of the ``model.blame.*`` drift family: the Tier-S
    counterpart (the profiler's ``profile_run``) measures the same
    categories on the simulated critical path, and CI gates their
    share-wise agreement like it already gates total latency.
    """
    mm = placement.model_mapping
    maps = mm.mappings
    links = placement.cascade_links()
    blame = {c: 0.0 for c in BLAME_CATEGORIES}
    if include_plio:
        first, last = maps[0], maps[-1]
        blame["shim_ingest"] = plio_cycles(first.layer.in_bytes,
                                           first.A * first.B, p=p, ideal=ideal)
        blame["shim_egress"] = plio_cycles(last.layer.out_bytes,
                                           last.A * last.C, p=p, ideal=ideal)
    for i, m in enumerate(maps):
        out_cas = i < len(links) and links[i]
        for k, v in layer_blame(m, out_cascade=out_cas, p=p,
                                ideal=ideal).items():
            blame[k] += v
    for e in edge_comms(placement, p=p, ideal=ideal):
        blame[f"comm_{e.kind}"] += e.cycles
    return blame


def blame_shares(blame: Dict[str, float]) -> Dict[str, float]:
    """Normalize a blame dict to fractions of its (signed) total."""
    total = sum(blame.values())
    if not total:
        return {k: 0.0 for k in blame}
    return {k: v / total for k, v in blame.items()}


# ---------------------------------------------------------------------------
# Calibration: fit OverheadParams to the paper's measured tables
# ---------------------------------------------------------------------------

def calibrate() -> Tuple[OverheadParams, Dict[str, float]]:
    """Least-squares fit of the overhead constants to Table 2 / Table 4.

    Returns the fitted params and a dict of mean-absolute-percentage errors.
    The fitted values are frozen into :data:`repro_torch.core.aie_arch.OVERHEADS`;
    ``tests/test_perfmodel.py`` asserts the frozen values still match.
    """
    bm, bk, bn = _blk("int8")

    # --- no-BR rows: cycles = njl*(4*W1/bk) + njl*l_epi + l_o + s*out_bytes
    rows, ys = [], []
    for (m, k, n), (_, _, uorca, _) in TABLE2_NS.items():
        njl = j_loops(m, n)
        ideal = njl * 4.0 * k / bk
        meas = aie_arch.cycles_from_ns(uorca)
        rows.append([njl, 1.0, float(m * n)])
        ys.append(meas - ideal)
    A = np.array(rows)
    y = np.array(ys)
    (l_epi, l_o, s), *_ = np.linalg.lstsq(A, y, rcond=None)

    # --- +BR deltas: extra = br_w2*W2 + br_h1*H1 + br_fixed
    rows, ys = [], []
    for (m, k, n), (_, _, uorca, uorca_br) in TABLE2_NS.items():
        delta = aie_arch.cycles_from_ns(uorca_br - uorca)
        rows.append([float(n), float(m), 1.0])
        ys.append(delta)
    (br_w2, br_h1, br_f), *_ = np.linalg.lstsq(np.array(rows), np.array(ys),
                                               rcond=None)

    # --- Table 4 ours: agg_fixed + agg_per_aie*A + vmacs (H1 = per-AIE rows)
    rows, ys = [], []
    for (m, f, a), (_, ours) in TABLE4_NS.items():
        h1 = max(2 * bm, m // a)
        vmacs = math.ceil(h1 / bk) * math.ceil(f / bn)
        rows.append([1.0, float(a)])
        ys.append(aie_arch.cycles_from_ns(ours) - vmacs)
    (agg_fixed, agg_per_aie), *_ = np.linalg.lstsq(np.array(rows), np.array(ys),
                                                   rcond=None)

    # --- Table 4 baseline: fixed + per_aie*A + per_elem*(H1*W2)
    rows, ys = [], []
    for (m, f, a), (base, _) in TABLE4_NS.items():
        h1 = max(2 * bm, m // a)
        rows.append([1.0, float(a), float(h1 * f)])
        ys.append(aie_arch.cycles_from_ns(base))
    (ab_fixed, ab_aie, ab_elem), *_ = np.linalg.lstsq(np.array(rows),
                                                      np.array(ys), rcond=None)

    fitted = dataclasses.replace(
        OVERHEADS,
        l_epi=float(l_epi), l_o=float(l_o), l_o_store_dma=float(s),
        br_w2=float(br_w2), br_h1=float(br_h1), br_fixed=float(br_f),
        agg_fixed=float(agg_fixed), agg_per_aie=float(agg_per_aie),
        agg_base_fixed=float(ab_fixed), agg_base_per_aie=float(ab_aie),
        agg_base_per_elem=float(ab_elem),
    )
    errs = model_errors(fitted)
    return fitted, errs


def model_errors(p: OverheadParams = OVERHEADS) -> Dict[str, float]:
    """Mean-absolute-percentage error of the model vs Table 2 / Table 4."""
    errs_nobr, errs_br, errs_agg = [], [], []
    for (m, k, n), (_, _, uorca, uorca_br) in TABLE2_NS.items():
        est = aie_arch.ns(single_aie_cycles(m, k, n, p=p))
        errs_nobr.append(abs(est - uorca) / uorca)
        est_br = aie_arch.ns(single_aie_cycles(m, k, n, bias_relu=True, p=p))
        errs_br.append(abs(est_br - uorca_br) / uorca_br)
    for (m, f, a), (base, ours) in TABLE4_NS.items():
        h1 = max(8, m // a)
        est = aie_arch.ns(agg_ours_cycles(a, h1, f, p=p))
        errs_agg.append(abs(est - ours) / ours)
    return {
        "table2_nobr_mape": float(np.mean(errs_nobr)),
        "table2_br_mape": float(np.mean(errs_br)),
        "table2_all_mape": float(np.mean(errs_nobr + errs_br)),
        "table4_ours_mape": float(np.mean(errs_agg)),
    }


# ---------------------------------------------------------------------------
# Baseline estimators for Fig. 9 (model-error comparison)
# ---------------------------------------------------------------------------

def gama_estimate_cycles(H1: int, W1: int, W2: int, dtype: str = "int8") -> float:
    """GAMA-style theoretical cycle count: ideal MACs/256 (over-optimistic)."""
    return H1 * W1 * W2 / aie_arch.MACS_PER_CYCLE_INT8


def ssr_estimate_cycles(H1: int, W1: int, W2: int, dtype: str = "int8") -> float:
    """SSR-style profile-based estimate.

    SSR profiles large array workloads and back-derives per-kernel cost,
    folding PLIO/array-level sync into the per-kernel constant — accurate in
    situ, but over-pessimistic for small standalone kernels (paper Fig. 9:
    72.3% error). We model it as ideal + large profiled fixed cost.
    """
    SSR_PROFILED_OVERHEAD = 100.0   # cycles, amortized array-level cost
    return H1 * W1 * W2 / aie_arch.MACS_PER_CYCLE_INT8 + SSR_PROFILED_OVERHEAD
