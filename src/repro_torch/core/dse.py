"""Design space exploration for mapping + placement (paper §5.2, Fig. 8).

The paper brute-forces the per-layer spatial parallelism ``(A_i, B_i, C_i)``
(powers of two) subject to

  * total tiles:  Σ A_i·B_i·C_i  <=  T_m · T_n
  * PLIO budget:  A_1·B_1 + A_n·C_n  <=  P

then places layers bottom-left sequentially; cascade is used on an edge when
the mappings are compatible (A = A', C = C' = 1) *and* the consumer landed
directly east of the producer.

A naive product over layers explodes (~10^2 mappings/layer ^ 13 layers), so we
run the same search as an exact *Pareto dynamic program*: the end-to-end cost
(§5.1: Σ L_comp + Σ L_comm) is Markovian in the previous layer's mapping —
layer i's computation cost depends on its own mapping and on whether edge
i→i+1 cascades, which depends only on (mapping_i, mapping_{i+1}). The only
global couplings are the tile budget (handled by keeping, per DP state, the
Pareto frontier over {tiles used, cost}) and placement adjacency (handled by
re-scoring the top-K DP solutions with the real placement, which also fixes
the Manhattan distances in the DMA term). This is exhaustive over the paper's
space modulo the distance estimate, and the re-scoring step restores exactness
for every design it returns.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import aie_arch
from . import perfmodel_batched as pmb
from .aie_arch import OverheadParams, OVERHEADS
from .layerspec import ModelSpec
from .mapping import Mapping, ModelMapping, cascade_compatible, enumerate_mappings
from .placement import Placement, place
from .perfmodel import (LatencyBreakdown, cascade_comm_cycles, dma_comm_cycles,
                        end_to_end_cycles, initiation_interval_cycles,
                        latency_blame, layer_comp_cycles, layer_occupancy,
                        plio_cycles, shim_stage_cycles)


@dataclasses.dataclass
class DSEResult:
    model: ModelSpec
    mapping: ModelMapping
    placement: Placement
    latency: LatencyBreakdown
    candidates_scored: int
    dp_states: int
    #: Tier-S simulated end-to-end cycles, filled when the design was
    #: re-scored by the discrete-event simulator (search(rescore=...)).
    sim_cycles: Optional[float] = None
    #: Congestion-free pipelined initiation interval (bottleneck stage of
    #: perfmodel.pipeline_stages). II <= latency; a pipelined instance
    #: sustains 1/II events/cycle even though each event takes the full
    #: latency to flow through.
    interval_cycles: Optional[float] = None
    #: Closed-form latency attribution (perfmodel.latency_blame), filled by
    #: ``search(explain=True)`` — signed cycles per blame category.
    blame: Optional[Dict[str, float]] = None

    @property
    def latency_ns(self) -> float:
        return self.latency.total_ns

    @property
    def sim_latency_ns(self) -> Optional[float]:
        return None if self.sim_cycles is None else aie_arch.ns(self.sim_cycles)

    @property
    def interval_ns(self) -> Optional[float]:
        return (None if self.interval_cycles is None
                else aie_arch.ns(self.interval_cycles))

    @property
    def cascade_edges(self) -> int:
        return sum(self.placement.cascade_links())

    @property
    def dominant_blame(self) -> Optional[Tuple[str, float]]:
        """(category, share) of the largest blame category, or None when
        the design was not scored with ``explain=True``."""
        if not self.blame:
            return None
        total = sum(self.blame.values())
        cat = max(self.blame, key=lambda c: abs(self.blame[c]))
        return cat, (self.blame[cat] / total if total else 0.0)

    def why_wins(self) -> str:
        """One-line attribution of where this design's latency goes."""
        if not self.blame:
            return "(no blame annotation; use dse.search(explain=True))"
        total = sum(self.blame.values())
        top = sorted(self.blame.items(), key=lambda kv: -abs(kv[1]))[:3]
        parts = ", ".join(
            f"{c} {100 * v / total:.0f}%" if total else c for c, v in top)
        return f"dominated by {parts}"

    def summary(self) -> str:
        maps = ", ".join(f"{m.A}x{m.B}x{m.C}" for m in self.mapping.mappings)
        s = (f"{self.model.name}: {self.latency_ns:.1f} ns, "
             f"{self.mapping.total_tiles} tiles, "
             f"{self.cascade_edges}/{self.model.num_layers - 1} cascade edges, "
             f"maps [{maps}]")
        if self.blame:
            s += f" — {self.why_wins()}"
        return s


def _edge_cost_estimate(prev: Mapping, nxt: Mapping, *, force_dma: bool,
                        p: OverheadParams) -> Tuple[float, bool]:
    """(cost, is_cascade) for an inter-layer edge, distance estimated.

    The Manhattan-distance estimate assumes sequential bottom-left placement:
    adjacent rectangles are ~(width_prev + width_next) apart at worst.
    """
    if not force_dma and cascade_compatible(prev, nxt):
        return cascade_comm_cycles(p=p), True
    d_est = prev.cols + nxt.cols + abs(prev.rows - nxt.rows)
    data = prev.layer.out_bytes
    n_streams = max(1, min(prev.A * prev.C, nxt.A * nxt.B))
    return dma_comm_cycles(math.ceil(data / n_streams) * n_streams, d_est,
                           n_streams=n_streams, p=p), False


#: Below this many items the scalar Pareto paths win (no array setup cost)
#: and stay as the behavioral reference the vectorized kernels must match.
_PARETO_VECTOR_MIN = 64


def _key_matrix(items: Sequence, key: Callable) -> Optional[np.ndarray]:
    """Key tuples as a float [n, d] matrix, or None when any key is
    non-numeric / ragged (the scalar path handles those)."""
    try:
        mat = np.array([tuple(key(it)) for it in items], dtype=np.float64)
    except (TypeError, ValueError):
        return None
    if mat.ndim != 2 or np.isnan(mat).any():
        return None
    return mat


def _lexsort_rows(mat: np.ndarray) -> np.ndarray:
    """Stable lexicographic row order (first column primary), matching
    ``sorted(items, key=key)`` on the same tuples."""
    return np.lexsort(tuple(mat[:, d] for d in range(mat.shape[1] - 1, -1, -1)))


def _pareto_mask_sorted(mat: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """Keep-mask of the Pareto frontier (every column minimized) over rows
    already in lexicographic order.

    A sorted row is dominated iff *some earlier row* is ``<=`` in every
    coordinate (any dominator sorts first; exact duplicates drop against
    their first copy). By transitivity it suffices to test (a) earlier
    *kept* rows and (b) earlier rows of the same block — so each block is
    one ``[blk, kept, d]`` broadcast plus one upper-triangular in-block
    matrix, never an O(n^2) pass over everything."""
    n, d = mat.shape
    keep = np.zeros(n, dtype=bool)
    kept_rows: List[np.ndarray] = []
    for start in range(0, n, chunk):
        blk = mat[start:start + chunk]
        dom = np.zeros(len(blk), dtype=bool)
        for kr in kept_rows:
            todo = ~dom
            if not todo.any():
                break
            dom[todo] |= ((kr[:, None, :] <= blk[todo][None, :, :])
                          .all(-1).any(0))
        inb = (blk[:, None, :] <= blk[None, :, :]).all(-1)
        dom |= np.triu(inb, 1).any(axis=0)
        keep[start:start + chunk] = ~dom
        survivors = blk[~dom]
        if len(survivors):
            kept_rows.append(survivors)
    return keep


def pareto_front(items: Sequence, key: Callable) -> List:
    """Generic 2-D Pareto filter: ``key(item) -> (primary, secondary)``,
    both minimized. Returns items sorted by ascending primary, keeping one
    per primary value — the one whose secondary strictly beats every kept
    predecessor. Shared by :func:`search` and
    the multi-tenant packer's throughput frontier (not ported yet).

    Large numeric inputs take a vectorized path (sort + exclusive running
    minimum of the secondary); small or non-numeric inputs keep the scalar
    loop. The two agree exactly (property-tested)."""
    items = list(items)
    if len(items) >= _PARETO_VECTOR_MIN:
        mat = _key_matrix(items, key)
        if mat is not None and mat.shape[1] == 2:
            order = _lexsort_rows(mat)
            sec = mat[order, 1]
            # kept[i] <=> sec[i] beats every kept predecessor <=> sec[i]
            # beats the exclusive running min over *all* predecessors
            # (any non-kept predecessor has a kept row at or below it).
            prev_min = np.concatenate(
                ([np.inf], np.minimum.accumulate(sec)[:-1]))
            return [items[i] for i in order[sec < prev_min]]
    front: List = []
    for it in sorted(items, key=key):
        if all(key(it)[1] < key(kept)[1] for kept in front):
            front.append(it)
    return front


def pareto_front_nd(items: Sequence, key: Callable) -> List:
    """N-dimensional Pareto filter: ``key(item) -> tuple``, every
    coordinate minimized. Keeps items no other item dominates (dominates =
    ``<=`` in every coordinate and a different key tuple; exact-duplicate
    keys keep the first), sorted by ascending key. Used by :func:`search`
    for the {tiles, latency, initiation interval} frontier — a design with
    worse latency but a deeper pipeline (smaller II) now survives.

    Large numeric inputs go through the chunked numpy dominance kernel
    (:func:`_pareto_mask_sorted`), which is what keeps exact fronts over
    10^5+ exhaustive-DSE candidates cheap; small or non-numeric inputs use
    the scalar loop. The two agree exactly (property-tested)."""
    items = list(items)
    if len(items) >= _PARETO_VECTOR_MIN:
        mat = _key_matrix(items, key)
        if mat is not None:
            order = _lexsort_rows(mat)
            mask = _pareto_mask_sorted(mat[order])
            return [items[i] for i in order[mask]]
    kept: List = []
    seen = set()
    for it in sorted(items, key=key):
        k = key(it)
        if k in seen:
            continue
        # Sorting is lexicographic, so any dominator of ``it`` sorts before
        # it and (being undominated itself, by transitivity) is in ``kept``.
        if any(all(a <= b for a, b in zip(key(kp), k)) for kp in kept):
            continue
        kept.append(it)
        seen.add(k)
    return kept


def _pareto_insert(frontier: List[Tuple[int, float, tuple]], tiles: int,
                   cost: float, back: tuple, cap: int = 24) -> bool:
    """Insert (tiles, cost) into a Pareto frontier (fewer tiles, lower cost)."""
    for t, c, _ in frontier:
        if t <= tiles and c <= cost:
            return False
    frontier[:] = [(t, c, b) for t, c, b in frontier
                   if not (tiles <= t and cost <= c)]
    frontier.append((tiles, cost, back))
    if len(frontier) > cap:
        frontier.sort(key=lambda x: x[1])
        del frontier[cap:]
    return True


class _Telemetry:
    """Null-safe telemetry shim: no-ops when registry/tracer are absent, so
    the search pays nothing unless observability was requested."""

    def __init__(self, registry, tracer, model_name: str) -> None:
        self.reg = registry
        self.tracer = tracer
        self.model = model_name

    def count(self, name: str, n: float = 1.0) -> None:
        if self.reg is not None:
            self.reg.counter(name, {"model": self.model}).inc(n)

    def gauge(self, name: str, value: float, **labels) -> None:
        if self.reg is not None:
            self.reg.gauge(name, {"model": self.model, **labels}).set(value)

    class _Phase:
        def __init__(self, outer: "_Telemetry", phase: str) -> None:
            self.outer, self.phase = outer, phase

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            o = self.outer
            o.gauge("dse.walltime_s", dt, phase=self.phase)
            if o.tracer is not None:
                end = o.tracer.now_us()
                o.tracer.span_us("dse", o.model, self.phase,
                                 end - dt * 1e6, dt * 1e6, cat="dse")
            return False

    def phase(self, name: str) -> "_Telemetry._Phase":
        return self._Phase(self, name)


def _dp_finals(model: ModelSpec, *,
               rows: int, cols: int, plio: int, dtype: str,
               p: OverheadParams, force_dma: bool,
               max_tiles_per_layer: Optional[int],
               include_plio: bool):
    """Run the Pareto DP; returns (finals, layer_maps, dp_states) or None.

    ``finals`` is the estimate-cost-sorted list of (cost, backpointer) over
    every surviving DP terminal; backpointers index into ``layer_maps``.
    """
    total_tiles = rows * cols
    per_layer_cap = max_tiles_per_layer or total_tiles
    layer_maps: List[List[Mapping]] = []
    for layer in model.layers:
        ms = [m for m in enumerate_mappings(layer, per_layer_cap, dtype)
              if m.rows <= rows and m.cols <= cols]
        if not ms:
            return None
        layer_maps.append(ms)

    # --- Pareto DP over (layer index, mapping) states ---------------------
    # frontier[state] = list of (tiles_used, cost_so_far, backpointer)
    # backpointer = (prev_state_idx, prev_frontier_entry) chain, materialized
    # as an immutable tuple of mapping indices for simplicity.
    n_layers = model.num_layers
    dp: Dict[int, List[Tuple[int, float, tuple]]] = {}
    first = model.layers[0]
    for j, m in enumerate(layer_maps[0]):
        tiles = m.tiles
        if tiles > total_tiles:
            continue
        if m.A * m.B > plio - 1:   # leave >=1 port for the last layer's store
            continue
        cost = plio_cycles(first.in_bytes, m.A * m.B, p=p) if include_plio else 0.0
        _pareto_insert(dp.setdefault(j, []), tiles, cost, (j,))
    dp_states = len(dp)

    for i in range(1, n_layers):
        ndp: Dict[int, List[Tuple[int, float, tuple]]] = {}
        for jprev, frontier in dp.items():
            mprev = layer_maps[i - 1][jprev]
            for jnxt, mnxt in enumerate(layer_maps[i]):
                ecost, is_cas = _edge_cost_estimate(mprev, mnxt,
                                                    force_dma=force_dma, p=p)
                # layer i-1 computation cost is resolved now that we know
                # whether its output leaves via cascade.
                ccost = layer_comp_cycles(mprev, out_cascade=is_cas, p=p)
                for tiles, cost, back in frontier:
                    t2 = tiles + mnxt.tiles
                    if t2 > total_tiles:
                        continue
                    _pareto_insert(ndp.setdefault(jnxt, []),
                                   t2, cost + ccost + ecost, back + (jnxt,))
        dp = ndp
        dp_states += len(dp)
        if not dp:
            return None

    # --- collect finals: add last layer comp + PLIO out + constraints ------
    finals: List[Tuple[float, tuple]] = []
    last = model.layers[-1]
    for j, frontier in dp.items():
        mlast = layer_maps[-1][j]
        ccost = layer_comp_cycles(mlast, out_cascade=False, p=p)
        ocost = (plio_cycles(last.out_bytes, mlast.A * mlast.C, p=p)
                 if include_plio else 0.0)
        for tiles, cost, back in frontier:
            finals.append((cost + ccost + ocost, back))
    finals.sort(key=lambda x: x[0])
    return finals, layer_maps, dp_states


def _score_back(model: ModelSpec, back: tuple, layer_maps, *,
                rows: int, cols: int, plio: int,
                p: OverheadParams, force_dma: bool,
                include_plio: bool, dp_states: int) -> Optional[DSEResult]:
    """Re-score one DP backpointer with the real placement (restores
    exactness of the DMA Manhattan distances)."""
    maps = tuple(layer_maps[i][j] for i, j in enumerate(back))
    mm = ModelMapping(model=model, mappings=maps)
    if not mm.fits(rows, cols, plio):
        return None
    pl = place(mm, rows, cols)
    if pl is None:
        return None
    lat = end_to_end_cycles(pl, p=p, include_plio=include_plio)
    if force_dma:
        # ablation: cost every edge as DMA even if adjacency allows cascade,
        # and price the initiation interval on the same all-DMA stages
        # (cascade stages would understate the ablation's bottleneck).
        lat = _recost_all_dma(pl, p=p, include_plio=include_plio)
        stages = [max(d for _, _, _, d in
                      layer_occupancy(m, out_cascade=False, p=p).spans)
                  for m in maps] + list(lat.comm)
        if include_plio:
            _, t_in, t_out = shim_stage_cycles(pl, p=p)
            stages.append(t_in + t_out)
        interval = max(stages)
    else:
        interval = initiation_interval_cycles(pl, p=p,
                                              include_plio=include_plio)
    return DSEResult(model=model, mapping=mm, placement=pl, latency=lat,
                     candidates_scored=0, dp_states=dp_states,
                     interval_cycles=interval)


# ---------------------------------------------------------------------------
# Exhaustive mode: uncapped Pareto DP over the full mapping space, scored
# by the batched Tier-A model (repro_torch.core.perfmodel_batched)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _StateCands:
    """Pareto-frontier candidates of one DP state, as parallel arrays.

    ``key = (j, ports0)``: the state is the last layer's mapping index plus
    the first layer's PLIO load ports. ``ports0`` is part of the key (not a
    dominance axis) because the terminal shim-stage estimate is not monotone
    in it — two prefixes only compare when they demand the same ingest
    ports. ``par_state``/``par_idx`` chain back into the previous layer's
    state list for mapping reconstruction."""

    key: Tuple[int, int]
    tiles: np.ndarray
    cost: np.ndarray
    mstage: np.ndarray
    par_state: np.ndarray
    par_idx: np.ndarray


def _sorted_pareto(tiles, cost, mstage, extra: List[np.ndarray]):
    """Lossless 3-D Pareto prune of one state's candidates (+ parallel
    payload columns), returning everything lex-sorted and undominated."""
    mat = np.stack([tiles.astype(np.float64), cost, mstage], axis=1)
    order = _lexsort_rows(mat)
    mask = _pareto_mask_sorted(mat[order])
    idx = order[mask]
    return tiles[idx], cost[idx], mstage[idx], [e[idx] for e in extra]


def _exhaustive_frontier(model: ModelSpec, *, rows: int, cols: int, plio: int,
                         dtype: str, p: OverheadParams, force_dma: bool,
                         max_tiles_per_layer: Optional[int],
                         include_plio: bool, chunk: int, obs: "_Telemetry"
                         ) -> List[DSEResult]:
    """Enumerate + score the *full* feasible per-layer tiling space.

    Same Markov decomposition as :func:`_dp_finals`, but nothing is capped:
    instead of a 24-deep {tiles, cost} frontier per state and a top-K
    truncation of the finals, every DP state keeps its complete Pareto
    frontier over {tiles, estimate latency, max pipeline stage} (the three
    quantities through which a prefix influences any completion's final
    {tiles, latency, II}), so the pruning is lossless w.r.t. the DP's
    estimate-distance cost model: two prefixes in the same ``(last mapping,
    ingest ports)`` state see identical suffix increments, hence a
    dominated prefix cannot produce an estimate-frontier point. All
    per-state transition costs are precomputed as numpy tables via the
    batched Tier-A twins and applied to whole candidate arrays in
    ``chunk``-bounded blocks; every surviving frontier design is then
    placed for real and re-scored in one :func:`pmb.score_batch` pass
    (exact Manhattan distances + the shim bandwidth cap), which restores
    exactness for everything returned."""
    total_tiles = rows * cols
    per_layer_cap = max_tiles_per_layer or total_tiles
    layer_maps: List[List[Mapping]] = []
    for layer in model.layers:
        ms = [m for m in enumerate_mappings(layer, per_layer_cap, dtype)
              if m.rows <= rows and m.cols <= cols]
        if not ms:
            return []
        layer_maps.append(ms)
    n_layers = model.num_layers

    # --- per-layer constant tables (batched Tier-A twins) ------------------
    lA = [np.array([m.A for m in ms], np.int64) for ms in layer_maps]
    lB = [np.array([m.B for m in ms], np.int64) for ms in layer_maps]
    lC = [np.array([m.C for m in ms], np.int64) for ms in layer_maps]
    lH1 = [np.array([m.H1 for m in ms], np.int64) for ms in layer_maps]
    lW1 = [np.array([m.W1 for m in ms], np.int64) for ms in layer_maps]
    lW2 = [np.array([m.W2 for m in ms], np.int64) for ms in layer_maps]
    ltiles = [a * b * c for a, b, c in zip(lA, lB, lC)]
    comp = {}
    busy = {}
    for i, layer in enumerate(model.layers):
        kw = dict(A=lA[i], B=lB[i], C=lC[i], H1=lH1[i], W1=lW1[i], W2=lW2[i],
                  is_agg=layer.kind == "agg",
                  bias_relu=bool(layer.bias or layer.relu), p=p, dtype=dtype)
        for cas in (False, True):
            flag = np.full(len(layer_maps[i]), cas)
            comp[i, cas] = pmb.layer_comp_cycles_v(out_cascade=flag, **kw)
            busy[i, cas] = pmb.layer_busy_cycles_v(out_cascade=flag, **kw)

    # --- per-edge transition tables [J_prev, J_next] -----------------------
    trans_cost: List[np.ndarray] = []
    trans_stage: List[np.ndarray] = []
    for i in range(n_layers - 1):
        mp, mn = layer_maps[i], layer_maps[i + 1]
        is_cas = np.zeros((len(mp), len(mn)), bool)
        if not force_dma:
            for a, ma in enumerate(mp):
                for b, mb in enumerate(mn):
                    is_cas[a, b] = cascade_compatible(ma, mb)
        rows_p = (lA[i] * lC[i])[:, None]
        cols_p = lB[i][:, None]
        d_est = cols_p + lB[i + 1][None, :] + np.abs(
            rows_p - (lA[i + 1] * lC[i + 1])[None, :])
        data = model.layers[i].out_bytes
        ns = np.maximum(1, np.minimum((lA[i] * lC[i])[:, None],
                                      (lA[i + 1] * lB[i + 1])[None, :]))
        padded = pmb._ceil_div(data, ns) * ns
        dma = pmb.dma_comm_cycles_v(padded, d_est, n_streams=ns, p=p)
        ecost = np.where(is_cas, cascade_comm_cycles(p=p), dma)
        ccost = np.where(is_cas, comp[i, True][:, None],
                         comp[i, False][:, None])
        bstage = np.where(is_cas, busy[i, True][:, None],
                          busy[i, False][:, None])
        trans_cost.append(ccost + ecost)
        trans_stage.append(np.maximum(bstage, ecost))

    # tightest completion any suffix can manage, for early tile pruning
    min_rest = [0] * n_layers
    for i in range(n_layers - 2, -1, -1):
        min_rest[i] = min_rest[i + 1] + int(ltiles[i + 1].min())

    # --- layer 0 states ----------------------------------------------------
    first = model.layers[0]
    states: List[_StateCands] = []
    for j, m in enumerate(layer_maps[0]):
        if m.tiles > total_tiles - min_rest[0]:
            continue
        if m.A * m.B > plio - 1:   # leave >=1 port for the last layer's store
            continue
        cost0 = (plio_cycles(first.in_bytes, m.A * m.B, p=p)
                 if include_plio else 0.0)
        states.append(_StateCands(
            key=(j, m.A * m.B), tiles=np.array([m.tiles], np.int64),
            cost=np.array([cost0]), mstage=np.array([0.0]),
            par_state=np.array([-1], np.int64),
            par_idx=np.array([-1], np.int64)))
    levels = [states]
    enumerated = len(states)
    dp_states = len(states)

    # --- forward sweep -----------------------------------------------------
    for i in range(1, n_layers):
        jn_count = len(layer_maps[i])
        buffers: Dict[Tuple[int, int], List[Tuple[np.ndarray, ...]]] = {}
        budget = total_tiles - min_rest[i]
        for s_idx, st in enumerate(levels[-1]):
            jp, p0 = st.key
            tc = trans_cost[i - 1][jp]
            ts = trans_stage[i - 1][jp]
            n = len(st.tiles)
            step = max(1, chunk // max(jn_count, 1))
            for lo in range(0, n, step):
                sl = slice(lo, min(lo + step, n))
                tiles2 = st.tiles[sl][:, None] + ltiles[i][None, :]
                cost2 = st.cost[sl][:, None] + tc[None, :]
                mst2 = np.maximum(st.mstage[sl][:, None], ts[None, :])
                feas = tiles2 <= budget
                rows_idx = np.arange(sl.start, sl.stop, dtype=np.int64)
                for jn in range(jn_count):
                    ok = feas[:, jn]
                    if not ok.any():
                        continue
                    buffers.setdefault((jn, p0), []).append((
                        tiles2[ok, jn], cost2[ok, jn], mst2[ok, jn],
                        np.full(int(ok.sum()), s_idx, np.int64),
                        rows_idx[ok]))
        nstates: List[_StateCands] = []
        for key, parts in buffers.items():
            tiles = np.concatenate([b[0] for b in parts])
            cost = np.concatenate([b[1] for b in parts])
            mstage = np.concatenate([b[2] for b in parts])
            pstate = np.concatenate([b[3] for b in parts])
            pidx = np.concatenate([b[4] for b in parts])
            enumerated += len(tiles)
            tiles, cost, mstage, (pstate, pidx) = _sorted_pareto(
                tiles, cost, mstage, [pstate, pidx])
            nstates.append(_StateCands(key=key, tiles=tiles, cost=cost,
                                       mstage=mstage, par_state=pstate,
                                       par_idx=pidx))
        if not nstates:
            return []
        levels.append(nstates)
        dp_states += len(nstates)

    # --- terminals: close every candidate and take the global frontier -----
    last = model.layers[-1]
    fin_tiles, fin_cost, fin_ii, fin_state, fin_idx = [], [], [], [], []
    for s_idx, st in enumerate(levels[-1]):
        j, p0 = st.key
        m = layer_maps[-1][j]
        if p0 + m.A * m.C > plio:
            continue
        ccost = comp[n_layers - 1, False][j]
        ocost = (plio_cycles(last.out_bytes, m.A * m.C, p=p)
                 if include_plio else 0.0)
        ii = np.maximum(st.mstage, busy[n_layers - 1, False][j])
        if include_plio:
            shim = (plio_cycles(first.in_bytes, p0, p=p)
                    + plio_cycles(last.out_bytes, m.A * m.C, p=p))
            ii = np.maximum(ii, shim)
        fin_tiles.append(st.tiles)
        fin_cost.append(st.cost + ccost + ocost)
        fin_ii.append(ii)
        fin_state.append(np.full(len(st.tiles), s_idx, np.int64))
        fin_idx.append(np.arange(len(st.tiles), dtype=np.int64))
    if not fin_tiles:
        return []
    tiles = np.concatenate(fin_tiles)
    cost = np.concatenate(fin_cost)
    ii = np.concatenate(fin_ii)
    sstate = np.concatenate(fin_state)
    sidx = np.concatenate(fin_idx)
    obs.gauge("dse.exhaustive_candidates", float(enumerated))
    obs.gauge("dse.dp_states", float(dp_states))
    tiles, cost, ii, (sstate, sidx) = _sorted_pareto(tiles, cost, ii,
                                                     [sstate, sidx])

    # --- reconstruct mappings, place, re-score the batch exactly -----------
    results: List[DSEResult] = []
    placements: List[Placement] = []
    metas: List[ModelMapping] = []
    for s, r in zip(sstate, sidx):
        back: List[int] = []
        st = levels[-1][int(s)]
        row = int(r)
        for lvl in range(n_layers - 1, -1, -1):
            back.append(st.key[0])
            if lvl == 0:
                break
            nxt_state = int(st.par_state[row])
            row = int(st.par_idx[row])
            st = levels[lvl - 1][nxt_state]
        back.reverse()
        maps = tuple(layer_maps[i][j] for i, j in enumerate(back))
        mm = ModelMapping(model=model, mappings=maps)
        if not mm.fits(rows, cols, plio):
            continue
        pl = place(mm, rows, cols)
        if pl is None:
            continue
        metas.append(mm)
        placements.append(pl)
    if not placements:
        return []
    batch = pmb.DesignBatch.from_placements(placements, dtype=dtype)
    if force_dma:
        batch.cascade = np.zeros_like(batch.cascade)
    lat = pmb.end_to_end_cycles_v(batch, p=p, include_plio=include_plio)
    interval = pmb.initiation_interval_cycles_v(batch, p=p,
                                                include_plio=include_plio)
    for k, (mm, pl) in enumerate(zip(metas, placements)):
        links = pl.cascade_links()
        if force_dma:
            kinds = ["dma"] * (n_layers - 1)
        else:
            kinds = [("sharedmem" if mm.mappings[e + 1].layer.kind == "agg"
                      else "cascade") if links[e] else "dma"
                     for e in range(n_layers - 1)]
        breakdown = LatencyBreakdown(
            plio_in=float(lat.plio_in[k]), comp=list(lat.comp[k]),
            comm=list(lat.comm[k]), comm_kind=kinds,
            plio_out=float(lat.plio_out[k]))
        results.append(DSEResult(
            model=model, mapping=mm, placement=pl, latency=breakdown,
            candidates_scored=enumerated, dp_states=dp_states,
            interval_cycles=float(interval[k])))
    return results


def explore(model: ModelSpec, *,
            rows: int = aie_arch.ARRAY_ROWS,
            cols: int = aie_arch.ARRAY_COLS,
            plio: int = aie_arch.PLIO_PORTS,
            dtype: str = "int8",
            p: OverheadParams = OVERHEADS,
            force_dma: bool = False,
            max_tiles_per_layer: Optional[int] = None,
            top_k: int = 48,
            include_plio: bool = True,
            registry=None, tracer=None) -> Optional[DSEResult]:
    """Run the §5.2 DSE. ``force_dma=True`` gives the μ-ORCA-DMA ablation.
    ``registry``/``tracer`` record the same search telemetry as
    :func:`search`."""
    obs = _Telemetry(registry, tracer, model.name)
    with obs.phase("dp"):
        r = _dp_finals(model, rows=rows, cols=cols, plio=plio, dtype=dtype,
                       p=p, force_dma=force_dma,
                       max_tiles_per_layer=max_tiles_per_layer,
                       include_plio=include_plio)
    if r is None:
        return None
    finals, layer_maps, dp_states = r
    obs.gauge("dse.dp_states", dp_states)
    best: Optional[DSEResult] = None
    scored = 0
    with obs.phase("score"):
        for est_cost, back in finals[:top_k]:
            cand = _score_back(model, back, layer_maps, rows=rows, cols=cols,
                               plio=plio, p=p, force_dma=force_dma,
                               include_plio=include_plio, dp_states=dp_states)
            obs.count("dse.candidates_evaluated")
            if cand is None:
                continue
            scored += 1
            if best is None or cand.latency.total < best.latency.total:
                best = cand
    if best is not None:
        best.candidates_scored = scored
    return best


def search(model: ModelSpec, *,
           rows: int = aie_arch.ARRAY_ROWS,
           cols: int = aie_arch.ARRAY_COLS,
           plio: int = aie_arch.PLIO_PORTS,
           dtype: str = "int8",
           p: OverheadParams = OVERHEADS,
           force_dma: bool = False,
           max_tiles_per_layer: Optional[int] = None,
           top_k: int = 96,
           include_plio: bool = True,
           exhaustive: bool = False,
           chunk: int = 1 << 16,
           rescore: Optional[Callable[[DSEResult], float]] = None,
           explain: bool = False,
           registry=None, tracer=None) -> List[DSEResult]:
    """Placement-validated Pareto frontier over {tiles, latency, II}.

    Same search as :func:`explore`, but instead of only the latency winner it
    returns every design on the {tiles used, end-to-end latency, initiation
    interval} Pareto frontier among the re-scored top-K candidates, sorted
    by ascending tile count. This is the input to the multi-tenant
    throughput DSE (the multi-tenant packer): a design using fewer tiles
    admits more replicas on the shared array, one with a smaller II
    sustains a higher pipelined rate per replica, so designs that lose the
    single-instance latency race can win on events/sec either way — a
    fewer-replica deep-pipeline packing can beat a wide serial one.

    ``rescore`` is the Tier-S hook: a callable mapping a DSEResult to a cost
    in cycles (e.g. the Tier-S simulator's rescorer, the discrete-event
    simulated latency). When given, every top-K design is re-scored, its
    ``sim_cycles`` field is filled, and the Pareto filter ranks designs by
    {tiles, simulated latency} instead of the analytic estimate — designs
    whose analytic rank survives only by ignoring execution effects drop
    off the frontier.

    ``exhaustive=True`` sweeps the *full* feasible per-layer tiling space
    instead of the heuristic top-K: an uncapped Pareto DP (no 24-deep
    per-state frontier, no finals truncation — see
    :func:`_exhaustive_frontier`) whose transition costs are numpy tables
    from the batched Tier-A twins (:mod:`repro_torch.core.perfmodel_batched`),
    processed in ``chunk``-bounded blocks to bound memory. Every surviving
    design is placed and re-scored exactly in one batched pass, then
    *unioned* with the top-K path's designs (the DP prunes on
    estimate-distance costs, so the cross-check guarantees the returned
    frontier is a superset-or-equal of the top-K frontier) and filtered
    once more on the exact {tiles, latency, II} values. The result is the
    exact frontier of the estimate-swept space rather than a 96-sample of
    it — ``benchmarks/dse_throughput.py`` reports the points it finds that
    top-K missed.

    ``explain=True`` annotates every returned frontier design with its
    closed-form blame decomposition (``DSEResult.blame``, via
    :func:`repro_torch.core.perfmodel.latency_blame`) so each winner carries a
    one-line "why it wins" — :meth:`DSEResult.why_wins` names the dominant
    blame categories, which is what separates e.g. a shim-bound wide
    design from a prologue-bound deep one at the same latency.

    ``registry`` (a metrics registry) and ``tracer``
    (a span tracer) record search telemetry: counters
    ``dse.candidates_evaluated`` / ``dse.pareto_survivors`` /
    ``dse.rescore_invocations`` and per-phase wall time ``dse.walltime_s``
    (phases ``dp``, ``score``, ``rescore``, and for exhaustive mode
    ``exhaustive``), plus a span per phase on the ``dse`` trace lane and
    gauges ``dse.exhaustive_candidates`` / ``dse.dp_states``.
    """
    obs = _Telemetry(registry, tracer, model.name)
    with obs.phase("dp"):
        r = _dp_finals(model, rows=rows, cols=cols, plio=plio, dtype=dtype,
                       p=p, force_dma=force_dma,
                       max_tiles_per_layer=max_tiles_per_layer,
                       include_plio=include_plio)
    if r is None:
        return []
    finals, layer_maps, dp_states = r
    obs.gauge("dse.dp_states", dp_states)
    scored: List[DSEResult] = []
    with obs.phase("score"):
        for est_cost, back in finals[:top_k]:
            cand = _score_back(model, back, layer_maps, rows=rows, cols=cols,
                               plio=plio, p=p, force_dma=force_dma,
                               include_plio=include_plio, dp_states=dp_states)
            obs.count("dse.candidates_evaluated")
            if cand is not None:
                scored.append(cand)
    for cand in scored:
        cand.candidates_scored = len(scored)
    if exhaustive:
        with obs.phase("exhaustive"):
            ex = _exhaustive_frontier(
                model, rows=rows, cols=cols, plio=plio, dtype=dtype, p=p,
                force_dma=force_dma,
                max_tiles_per_layer=max_tiles_per_layer,
                include_plio=include_plio, chunk=chunk, obs=obs)
        # Union with the top-K designs: the exhaustive DP prunes on the
        # estimate-distance cost model, so keeping the top-K set alongside
        # guarantees no previously-found Pareto point is lost; the final
        # exact filter below arbitrates on real placement scores.
        sig = lambda d: tuple((m.A, m.B, m.C) for m in d.mapping.mappings)
        seen_sigs = {sig(d) for d in scored}
        scored.extend(d for d in ex if sig(d) not in seen_sigs)
    if rescore is not None:
        with obs.phase("rescore"):
            # Batch-capable rescorers (the simulator's fast path) score
            # the whole top-K in chunks, amortizing dispatch across the
            # candidate set; the per-design closure stays supported.
            batch = getattr(rescore, "score_batch", None)
            if batch is not None:
                for cand, cycles in zip(scored, batch(scored)):
                    cand.sim_cycles = float(cycles)
                    obs.count("dse.rescore_invocations")
            else:
                for cand in scored:
                    cand.sim_cycles = float(rescore(cand))
                    obs.count("dse.rescore_invocations")
    cost = ((lambda d: d.sim_cycles) if rescore is not None
            else (lambda d: d.latency.total))
    # Pareto filter: keep designs not dominated on (tiles, cost, II). The
    # II axis is what admits deep-pipeline designs that a pure
    # {tiles, latency} filter would discard as dominated.
    front = pareto_front_nd(
        scored,
        lambda d: (d.mapping.total_tiles, cost(d), d.interval_cycles))
    if explain:
        for d in front:
            d.blame = latency_blame(d.placement, p=p,
                                    include_plio=include_plio)
    obs.count("dse.pareto_survivors", len(front))
    return front


def _recost_all_dma(placement: Placement, *, p: OverheadParams,
                    include_plio: bool) -> LatencyBreakdown:
    """Cost a placement with every inter-layer edge forced to direct DMA
    (the μ-ORCA DMA ablation of §6.3)."""
    maps = placement.model_mapping.mappings
    dists = placement.dma_distances()
    first, last_m = maps[0], maps[-1]
    plio_in = (plio_cycles(first.layer.in_bytes, first.A * first.B, p=p)
               if include_plio else 0.0)
    plio_out = (plio_cycles(last_m.layer.out_bytes, last_m.A * last_m.C, p=p)
                if include_plio else 0.0)
    comp = [layer_comp_cycles(m, out_cascade=False, p=p) for m in maps]
    comm, kinds = [], []
    for i in range(len(maps) - 1):
        nxt = maps[i + 1]
        data = maps[i].layer.out_bytes
        n_streams = max(1, min(maps[i].A * maps[i].C, nxt.A * nxt.B))
        comm.append(dma_comm_cycles(math.ceil(data / n_streams) * n_streams,
                                    dists[i], n_streams=n_streams, p=p))
        kinds.append("dma")
    return LatencyBreakdown(plio_in=plio_in, comp=comp, comm=comm,
                            comm_kind=kinds, plio_out=plio_out)
