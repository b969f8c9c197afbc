"""Vectorized (batched) twin of the Tier-A performance model.

:mod:`repro_torch.core.perfmodel` evaluates one placed design at a time in scalar
Python — fine for re-scoring a top-K shortlist, hopeless for sweeping the
full {mapping, placement} space. This module evaluates **arrays of candidate
designs** in one numpy pass: a :class:`DesignBatch` holds the candidates of
one model as struct-of-arrays tensors ({A, B, C} splits and the derived
{H1, W1, W2} per-AIE shapes per layer, cascade/DMA edge flags, Manhattan
distances, shim-column counts), and the ``*_v`` functions are elementwise
twins of the scalar Eq. (1)-(6) pieces.

Contract with the scalar model (tested to float precision by
``tests/test_perfmodel_batched.py``): for every candidate ``i`` in a batch
built with :meth:`DesignBatch.from_placements`,

  * ``end_to_end_cycles_v(batch).total[i]``
    == ``perfmodel.end_to_end_cycles(placements[i]).total``, component by
    component (plio_in / per-layer comp / per-edge comm / plio_out), and
  * ``initiation_interval_cycles_v(batch)[i]``
    == ``perfmodel.initiation_interval_cycles(placements[i])``,

because each ``*_v`` function applies the *same* arithmetic (same operation
order, integer ceilings as exact integer ceil-divisions) over float64/int64
arrays. Any change to a scalar formula must be mirrored here; the parity
tests are the tripwire. Throughput: >= 1e5 designs/sec on a laptop core vs
~1e2-1e3 for the scalar loop (``benchmarks/dse_throughput.py`` measures
both), which is what lets ``dse.search(exhaustive=True)`` sweep the full
feasible space instead of a heuristic top-K.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import aie_arch
from .aie_arch import OverheadParams, OVERHEADS
from .layerspec import ModelSpec
from .placement import Placement


def _blk(dtype: str) -> Tuple[int, int, int]:
    return aie_arch.BLOCK_SHAPES[dtype]


def _ceil_div(a, b):
    """Exact integer ceil-division on arrays (matches ``math.ceil(a / b)``
    for non-negative integer operands without float round-off)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    return -(-a // b)


def _round_up(a, b):
    return _ceil_div(a, b) * b


# ---------------------------------------------------------------------------
# Eq. (1)-(2): single-AIE kernel latency (vectorized twins)
# ---------------------------------------------------------------------------

def j_loops_v(H1, W2, dtype: str = "int8"):
    """Vector twin of :func:`perfmodel.j_loops`."""
    bm, _, bn = _blk(dtype)
    H1 = np.asarray(H1, dtype=np.int64)
    W2 = np.asarray(W2, dtype=np.int64)
    return np.maximum(1, (H1 * W2) // (4 * bm * bn))


def l_j_cycles_v(W1, *, cascaded, p: OverheadParams = OVERHEADS,
                 dtype: str = "int8", ideal: bool = False):
    """Vector twin of :func:`perfmodel.l_j_cycles`; ``cascaded`` is a bool
    array (or scalar) selecting the Eq. (3) back-pressure stall."""
    _, bk, _ = _blk(dtype)
    base = 4.0 * np.asarray(W1, dtype=np.float64) / bk
    if ideal:
        return base
    return base + p.l_epi + p.l_cas * np.asarray(cascaded, dtype=np.float64)


def br_overhead_v(H1, W2, p: OverheadParams = OVERHEADS):
    """Vector twin of :func:`perfmodel.br_overhead` (same operation order)."""
    H1 = np.asarray(H1, dtype=np.float64)
    W2 = np.asarray(W2, dtype=np.float64)
    return np.maximum(0.0, p.br_w2 * W2 + p.br_h1 * H1 + p.br_fixed)


def single_aie_cycles_v(H1, W1, W2, *, bias_relu=False, store_local=True,
                        p: OverheadParams = OVERHEADS, dtype: str = "int8",
                        ideal: bool = False):
    """Vector twin of :func:`perfmodel.single_aie_cycles` (Eq. 1).

    ``bias_relu`` / ``store_local`` may be scalars or boolean arrays."""
    H1 = np.asarray(H1, dtype=np.int64)
    W2 = np.asarray(W2, dtype=np.int64)
    njl = j_loops_v(H1, W2, dtype).astype(np.float64)
    lj = l_j_cycles_v(W1, cascaded=False, p=p, dtype=dtype, ideal=ideal)
    if ideal:
        return njl * lj
    lo = np.full(np.broadcast(H1, W2).shape, p.l_o, dtype=np.float64)
    store = np.asarray(store_local, dtype=np.float64)
    lo = lo + store * (p.l_o_store_dma * (H1 * W2).astype(np.float64))
    br = np.asarray(bias_relu, dtype=np.float64)
    lo = lo + br * br_overhead_v(H1, W2, p)
    return njl * lj + lo


# ---------------------------------------------------------------------------
# Eq. (3)-(4) + Table 4: per-layer computation latency / busy occupancy
# ---------------------------------------------------------------------------

def agg_ours_cycles_v(A, H1, W2, *, p: OverheadParams = OVERHEADS,
                      ideal: bool = False, dtype: str = "int8"):
    """Vector twin of :func:`perfmodel.agg_ours_cycles`."""
    _, bk, bn = _blk(dtype)
    vmacs = (_ceil_div(H1, bk) * _ceil_div(W2, bn)).astype(np.float64)
    if ideal:
        return vmacs
    return p.agg_fixed + p.agg_per_aie * np.asarray(A, np.float64) + vmacs


def layer_comp_cycles_v(*, A, B, C, H1, W1, W2, is_agg: bool, bias_relu: bool,
                        out_cascade, p: OverheadParams = OVERHEADS,
                        dtype: str = "int8", ideal: bool = False):
    """Vector twin of :func:`perfmodel.layer_comp_cycles` (Eq. 4) for one
    layer across N candidates. ``is_agg``/``bias_relu`` are per-layer
    scalars (all candidates of a batch map the same model); ``out_cascade``
    is a bool array — whether candidate i's output leaves via cascade."""
    if is_agg:
        return agg_ours_cycles_v(A, H1, W2, p=p, ideal=ideal, dtype=dtype)
    B = np.asarray(B, dtype=np.int64)
    njl = j_loops_v(H1, W2, dtype).astype(np.float64)
    lj = l_j_cycles_v(W1, cascaded=B > 1, p=p, dtype=dtype, ideal=ideal)
    if ideal:
        return (njl + B - 1) * lj
    lo = p.l_o + np.where(
        np.asarray(out_cascade, bool), 0.0,
        p.l_o_store_dma * (np.asarray(H1, np.int64)
                           * np.asarray(W2, np.int64)).astype(np.float64))
    if bias_relu:
        lo = lo + br_overhead_v(H1, W2, p)
    return (njl + B - 1) * lj + lo


def layer_busy_cycles_v(*, A, B, C, H1, W1, W2, is_agg: bool, bias_relu: bool,
                        out_cascade, p: OverheadParams = OVERHEADS,
                        dtype: str = "int8", ideal: bool = False):
    """Bottleneck-tile occupancy of one layer across N candidates.

    Vector twin of ``max(dur for spans)`` of
    :func:`perfmodel.layer_occupancy` — the per-event busy time of the
    layer's critical tile, i.e. the layer's *pipeline stage* cycles."""
    if is_agg:
        total = agg_ours_cycles_v(A, H1, W2, p=p, ideal=ideal, dtype=dtype)
        if ideal:
            return total
        _, bk, bn = _blk(dtype)
        vmacs = (_ceil_div(H1, bk) * _ceil_div(W2, bn)).astype(np.float64)
        dur = p.agg_fixed + p.agg_per_aie + vmacs
        rows = np.asarray(A, np.int64) * np.asarray(C, np.int64)
        return np.where((dur <= 0) | (rows == 1), total, dur)
    njl = j_loops_v(H1, W2, dtype).astype(np.float64)
    lj = l_j_cycles_v(W1, cascaded=np.asarray(B, np.int64) > 1, p=p,
                      dtype=dtype, ideal=ideal)
    if ideal:
        return njl * lj
    lo = p.l_o + np.where(
        np.asarray(out_cascade, bool), 0.0,
        p.l_o_store_dma * (np.asarray(H1, np.int64)
                           * np.asarray(W2, np.int64)).astype(np.float64))
    if bias_relu:
        lo = lo + br_overhead_v(H1, W2, p)
    return njl * lj + lo


# ---------------------------------------------------------------------------
# Eq. (5)-(6) + PLIO: communication (vectorized twins)
# ---------------------------------------------------------------------------

def dma_comm_cycles_v(data_bytes, manhattan, *, n_streams=1,
                      p: OverheadParams = OVERHEADS, ideal: bool = False):
    """Vector twin of :func:`perfmodel.dma_comm_cycles` (Eq. 5)."""
    n_streams = np.asarray(n_streams, dtype=np.int64)
    xfer = _ceil_div(np.asarray(data_bytes, np.int64) * 8,
                     aie_arch.DMA_BITS_PER_CYCLE * n_streams
                     ).astype(np.float64)
    if ideal:
        return xfer
    return p.l_init + xfer + p.dma_hop * np.asarray(manhattan, np.float64)


def plio_cycles_v(data_bytes, ports, *, p: OverheadParams = OVERHEADS,
                  ideal: bool = False):
    """Vector twin of :func:`perfmodel.plio_cycles`."""
    ports = np.maximum(1, np.asarray(ports, dtype=np.int64))
    xfer = _ceil_div(np.asarray(data_bytes, np.int64) * 8,
                     p.plio_bits_per_cycle * ports).astype(np.float64)
    if ideal:
        return xfer
    return p.plio_init + xfer


def edge_comms_v(batch: "DesignBatch", i: int, *,
                 p: OverheadParams = OVERHEADS, ideal: bool = False):
    """Cycles of inter-layer edge ``i -> i+1`` across all candidates.

    Vector twin of one :class:`perfmodel.EdgeComm` entry: cascade /
    shared-memory edges cost the constant Eq. (6) gap, DMA edges the Eq. (5)
    latency with the candidate's striping and Manhattan distance."""
    data = batch.model.layers[i].out_bytes
    n_streams = np.maximum(
        1, np.minimum(batch.A[:, i] * batch.C[:, i],
                      batch.A[:, i + 1] * batch.B[:, i + 1]))
    padded = _ceil_div(data, n_streams) * n_streams
    dma = dma_comm_cycles_v(padded, batch.dist[:, i], n_streams=n_streams,
                            p=p, ideal=ideal)
    cas = 0.0 if ideal else p.o_cas
    return np.where(batch.cascade[:, i], cas, dma)


def shim_stage_cycles_v(batch: "DesignBatch", *,
                        p: OverheadParams = OVERHEADS,
                        streams_per_col: int = aie_arch.SHIM_STREAMS_PER_COL,
                        ideal: bool = False):
    """Vector twin of :func:`perfmodel.shim_stage_cycles`: per-candidate
    ``(t_in, t_out)`` — the per-column PLIO occupancy per event, with the
    effective port count capped by the shim bandwidth of the candidate's
    bounding-box columns."""
    first_ports = batch.A[:, 0] * batch.B[:, 0]
    last_ports = batch.A[:, -1] * batch.C[:, -1]
    cap = streams_per_col * batch.box_cols
    t_in = plio_cycles_v(batch.model.layers[0].in_bytes,
                         np.minimum(first_ports, cap), p=p, ideal=ideal)
    t_out = plio_cycles_v(batch.model.layers[-1].out_bytes,
                          np.minimum(last_ports, cap), p=p, ideal=ideal)
    return t_in, t_out


# ---------------------------------------------------------------------------
# The struct-of-arrays candidate batch
# ---------------------------------------------------------------------------

def derive_shapes(model: ModelSpec, A, B, C, dtype: str = "int8"):
    """Per-AIE kernel shapes ``(H1, W1, W2)`` for ``[N, L]`` split tensors.

    Vector twin of the :class:`repro_torch.core.mapping.Mapping` ``H1/W1/W2``
    properties: padded to the VMAC block grid exactly as the scalar model
    pads them."""
    bm, bk, bn = _blk(dtype)
    A = np.asarray(A, dtype=np.int64)
    B = np.asarray(B, dtype=np.int64)
    C = np.asarray(C, dtype=np.int64)
    M = np.array([l.M for l in model.layers], dtype=np.int64)
    K = np.array([l.K for l in model.layers], dtype=np.int64)
    N = np.array([l.N for l in model.layers], dtype=np.int64)
    H1 = _round_up(_ceil_div(M, A), 2 * bm)
    W1 = _round_up(_ceil_div(K, B), bk)
    W2 = _round_up(_ceil_div(N, C), 2 * bn)
    return H1, W1, W2


@dataclasses.dataclass
class DesignBatch:
    """N candidate designs of one model, as struct-of-arrays tensors.

    Per-layer tensors are ``[N, L]`` int64 (``A``/``B``/``C`` splits and
    the derived padded per-AIE shapes); per-edge tensors are ``[N, L-1]``
    (``cascade`` — edge priced as cascade/shared-mem vs DMA — and ``dist``,
    the Manhattan distance of DMA edges); ``box_cols`` is ``[N]`` — the
    number of shim columns under each candidate's bounding box."""

    model: ModelSpec
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    H1: np.ndarray
    W1: np.ndarray
    W2: np.ndarray
    cascade: np.ndarray
    dist: np.ndarray
    box_cols: np.ndarray
    dtype: str = "int8"

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def num_layers(self) -> int:
        return self.A.shape[1]

    @classmethod
    def from_arrays(cls, model: ModelSpec, A, B, C, *, cascade, dist,
                    box_cols, dtype: str = "int8") -> "DesignBatch":
        """Build a batch from raw ``[N, L]`` split tensors, deriving the
        per-AIE shapes. ``cascade``/``dist`` are ``[N, L-1]``; for a
        single-layer model pass empty ``[N, 0]`` arrays."""
        A = np.atleast_2d(np.asarray(A, dtype=np.int64))
        B = np.atleast_2d(np.asarray(B, dtype=np.int64))
        C = np.atleast_2d(np.asarray(C, dtype=np.int64))
        H1, W1, W2 = derive_shapes(model, A, B, C, dtype)
        return cls(model=model, A=A, B=B, C=C, H1=H1, W1=W1, W2=W2,
                   cascade=np.asarray(cascade, bool).reshape(A.shape[0], -1),
                   dist=np.asarray(dist, np.int64).reshape(A.shape[0], -1),
                   box_cols=np.asarray(box_cols, np.int64).reshape(-1),
                   dtype=dtype)

    @classmethod
    def from_placements(cls, placements: Sequence[Placement],
                        dtype: Optional[str] = None) -> "DesignBatch":
        """Gather placed designs of one model into a batch (the parity-test
        and benchmark entry point: every field is read off the real
        placement, so batched scores must match the scalar model exactly)."""
        if not placements:
            raise ValueError("need at least one placement")
        model = placements[0].model_mapping.model
        maps0 = placements[0].model_mapping.mappings
        dt = dtype or maps0[0].dtype
        L = model.num_layers
        n = len(placements)
        A = np.empty((n, L), np.int64)
        B = np.empty((n, L), np.int64)
        C = np.empty((n, L), np.int64)
        cascade = np.zeros((n, max(L - 1, 0)), bool)
        dist = np.zeros((n, max(L - 1, 0)), np.int64)
        box_cols = np.empty(n, np.int64)
        for i, pl in enumerate(placements):
            if pl.model_mapping.model.num_layers != L:
                raise ValueError("all placements must share one model")
            for j, m in enumerate(pl.model_mapping.mappings):
                A[i, j], B[i, j], C[i, j] = m.A, m.B, m.C
            if L > 1:
                cascade[i] = pl.cascade_links()
                dist[i] = pl.dma_distances()
            box_cols[i] = len(pl.shim_columns())
        return cls.from_arrays(model, A, B, C, cascade=cascade, dist=dist,
                               box_cols=box_cols, dtype=dt)

    @property
    def tiles(self) -> np.ndarray:
        """Total tiles used per candidate, ``[N]``."""
        return (self.A * self.B * self.C).sum(axis=1)

    @property
    def plio_ports(self) -> np.ndarray:
        """PLIO ports needed per candidate (first loads + last stores)."""
        return self.A[:, 0] * self.B[:, 0] + self.A[:, -1] * self.C[:, -1]


# ---------------------------------------------------------------------------
# End-to-end latency + initiation interval over a batch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedLatency:
    """Vector twin of :class:`perfmodel.LatencyBreakdown`: ``plio_in`` /
    ``plio_out`` are ``[N]``, ``comp`` is ``[N, L]``, ``comm`` ``[N, L-1]``."""

    plio_in: np.ndarray
    comp: np.ndarray
    comm: np.ndarray
    plio_out: np.ndarray

    @property
    def total(self) -> np.ndarray:
        # Accumulate left-to-right (not np.sum's pairwise order) so the
        # rounding matches the scalar ``sum(comp) + sum(comm)`` bit for bit.
        comp_sum = np.zeros(self.comp.shape[0])
        for i in range(self.comp.shape[1]):
            comp_sum = comp_sum + self.comp[:, i]
        comm_sum = np.zeros(self.comm.shape[0])
        for i in range(self.comm.shape[1]):
            comm_sum = comm_sum + self.comm[:, i]
        return self.plio_in + comp_sum + comm_sum + self.plio_out

    @property
    def total_ns(self) -> np.ndarray:
        return self.total * aie_arch.NS_PER_CYCLE


def _layer_kwargs(batch: DesignBatch, i: int) -> dict:
    layer = batch.model.layers[i]
    return dict(A=batch.A[:, i], B=batch.B[:, i], C=batch.C[:, i],
                H1=batch.H1[:, i], W1=batch.W1[:, i], W2=batch.W2[:, i],
                is_agg=layer.kind == "agg",
                bias_relu=bool(layer.bias or layer.relu))


def _out_cascade(batch: DesignBatch, i: int) -> np.ndarray:
    if i < batch.num_layers - 1:
        return batch.cascade[:, i]
    return np.zeros(batch.n, bool)


def end_to_end_cycles_v(batch: DesignBatch, *, p: OverheadParams = OVERHEADS,
                        ideal: bool = False,
                        include_plio: bool = True) -> BatchedLatency:
    """Vector twin of :func:`perfmodel.end_to_end_cycles` over a batch."""
    L = batch.num_layers
    n = batch.n
    if include_plio:
        plio_in = plio_cycles_v(batch.model.layers[0].in_bytes,
                                batch.A[:, 0] * batch.B[:, 0], p=p,
                                ideal=ideal)
        plio_out = plio_cycles_v(batch.model.layers[-1].out_bytes,
                                 batch.A[:, -1] * batch.C[:, -1], p=p,
                                 ideal=ideal)
    else:
        plio_in = np.zeros(n)
        plio_out = np.zeros(n)
    comp = np.empty((n, L))
    for i in range(L):
        comp[:, i] = layer_comp_cycles_v(
            out_cascade=_out_cascade(batch, i), p=p, dtype=batch.dtype,
            ideal=ideal, **_layer_kwargs(batch, i))
    comm = np.empty((n, max(L - 1, 0)))
    for i in range(L - 1):
        comm[:, i] = edge_comms_v(batch, i, p=p, ideal=ideal)
    return BatchedLatency(plio_in=plio_in, comp=comp, comm=comm,
                          plio_out=plio_out)


def stage_cycles_v(batch: DesignBatch, *, p: OverheadParams = OVERHEADS,
                   ideal: bool = False, include_plio: bool = True,
                   streams_per_col: int = aie_arch.SHIM_STREAMS_PER_COL
                   ) -> np.ndarray:
    """Per-candidate pipeline-stage occupancy matrix ``[N, S]``.

    Stage order mirrors :func:`perfmodel.pipeline_stages`: the shim stage
    (``t_in + t_out``, omitted when ``include_plio`` is False), one
    bottleneck-tile stage per layer, one comm stage per edge. The row-wise
    max is the candidate's initiation interval."""
    L = batch.num_layers
    cols: List[np.ndarray] = []
    if include_plio:
        t_in, t_out = shim_stage_cycles_v(batch, p=p, ideal=ideal,
                                          streams_per_col=streams_per_col)
        cols.append(t_in + t_out)
    for i in range(L):
        cols.append(layer_busy_cycles_v(
            out_cascade=_out_cascade(batch, i), p=p, dtype=batch.dtype,
            ideal=ideal, **_layer_kwargs(batch, i)))
    for i in range(L - 1):
        cols.append(edge_comms_v(batch, i, p=p, ideal=ideal))
    return np.stack(cols, axis=1)


def initiation_interval_cycles_v(batch: DesignBatch, *,
                                 p: OverheadParams = OVERHEADS,
                                 ideal: bool = False,
                                 include_plio: bool = True,
                                 streams_per_col: int =
                                 aie_arch.SHIM_STREAMS_PER_COL) -> np.ndarray:
    """Vector twin of :func:`perfmodel.initiation_interval_cycles`."""
    return stage_cycles_v(batch, p=p, ideal=ideal, include_plio=include_plio,
                          streams_per_col=streams_per_col).max(axis=1)


def latency_blame_v(batch: DesignBatch, *, p: OverheadParams = OVERHEADS,
                    ideal: bool = False, include_plio: bool = True):
    """Vector twin of :func:`perfmodel.latency_blame` over a batch.

    Returns ``{category: [N] float64}`` over
    :data:`perfmodel.BLAME_CATEGORIES`, mirroring the scalar accumulation
    order term by term (each Eq. (1)-(6) piece multiplied out separately,
    layers then edges left to right), so ``latency_blame_v(batch)[c][i]``
    ``== latency_blame(placements[i])[c]`` bit for bit — the parity tests
    assert ``==``, not ``isclose``.
    """
    from .perfmodel import BLAME_CATEGORIES
    _, bk, bn = _blk(batch.dtype)
    n = batch.n
    blame = {c: np.zeros(n) for c in BLAME_CATEGORIES}
    if include_plio:
        blame["shim_ingest"] = plio_cycles_v(
            batch.model.layers[0].in_bytes, batch.A[:, 0] * batch.B[:, 0],
            p=p, ideal=ideal)
        blame["shim_egress"] = plio_cycles_v(
            batch.model.layers[-1].out_bytes, batch.A[:, -1] * batch.C[:, -1],
            p=p, ideal=ideal)
    for i in range(batch.num_layers):
        layer = batch.model.layers[i]
        H1, W1, W2 = batch.H1[:, i], batch.W1[:, i], batch.W2[:, i]
        if layer.kind == "agg":
            vmacs = (_ceil_div(H1, bk) * _ceil_div(W2, bn)).astype(np.float64)
            blame["compute"] = blame["compute"] + vmacs
            if not ideal:
                blame["prologue"] = blame["prologue"] + p.agg_fixed
                blame["sync"] = blame["sync"] + (
                    p.agg_per_aie * batch.A[:, i].astype(np.float64))
            continue
        B = batch.B[:, i]
        n_eff = (j_loops_v(H1, W2, batch.dtype) + B - 1).astype(np.float64)
        base = 4.0 * np.asarray(W1, dtype=np.float64) / bk
        blame["compute"] = blame["compute"] + n_eff * base
        if ideal:
            continue
        blame["prologue"] = blame["prologue"] + (n_eff * p.l_epi + p.l_o)
        blame["sync"] = blame["sync"] + np.where(B > 1, n_eff * p.l_cas, 0.0)
        out_cas = _out_cascade(batch, i)
        store = np.where(out_cas, 0.0,
                         p.l_o_store_dma * (np.asarray(H1, np.int64)
                                            * np.asarray(W2, np.int64)
                                            ).astype(np.float64))
        if layer.bias or layer.relu:
            store = store + br_overhead_v(H1, W2, p)
        blame["store"] = blame["store"] + store
    for i in range(batch.num_layers - 1):
        linked = batch.cascade[:, i]
        # Scalar edge_comms prices every linked edge at the Eq. (6) gap;
        # the *kind* (cascade vs shared-mem into an agg consumer) only
        # names the category.
        cas_cat = ("comm_sharedmem"
                   if batch.model.layers[i + 1].kind == "agg"
                   else "comm_cascade")
        cycles = edge_comms_v(batch, i, p=p, ideal=ideal)
        blame[cas_cat] = blame[cas_cat] + np.where(linked, cycles, 0.0)
        blame["comm_dma"] = blame["comm_dma"] + np.where(linked, 0.0, cycles)
    return blame


def score_batch(batch: DesignBatch, *, p: OverheadParams = OVERHEADS,
                ideal: bool = False, include_plio: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-pass DSE scoring: ``(tiles, latency_cycles, interval_cycles)``
    arrays for every candidate — the three axes of the exact
    {tiles, latency, II} Pareto frontier."""
    lat = end_to_end_cycles_v(batch, p=p, ideal=ideal,
                              include_plio=include_plio)
    ii = initiation_interval_cycles_v(batch, p=p, ideal=ideal,
                                      include_plio=include_plio)
    return batch.tiles, lat.total, ii
