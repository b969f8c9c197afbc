"""Calibration harness: fit the overhead constants against Tier-S sweeps.

The Tier-A model (:mod:`repro_torch.core.perfmodel`, Eq. 1-6) is only as honest
as its :class:`~repro_torch.core.aie_arch.OverheadParams` constants. This module
keeps them honest the way the WSE-2 GEMM calibration recipe does (fit
``cycles = α·words + β·perimeter + γ`` against sweep measurements, report
R²/MAPE per kernel family): sweep the Tier-S simulator
(:func:`repro_torch.sim.run.sweep_latency_cycles`) over a grid of placed designs,
least-squares-fit the constants the model is *affine* in, and emit a
fig9-style :class:`CalibrationReport` that CI gates on.

Why this works exactly: for every design, ``end_to_end_cycles`` is an
affine function of the fit set — each constant enters multiplied by a
shape-dependent coefficient (``l_o`` once per layer, ``l_o_store_dma`` by
the stored elements, ``l_epi``/``l_cas`` by the j-loop trip counts,
``o_cas`` per cascade edge, ``l_init + dma_hop·D`` per DMA edge,
``plio_init`` per PLIO endpoint, ``agg_fixed + agg_per_aie·A`` per
aggregation layer). So the design matrix is built generically, without
hand-deriving a single coefficient: column *k* is the model evaluated with
constant *k* set to 1 and the rest of the fit set zeroed, minus the
all-zeroed base. The ``br_*`` epilogue constants sit inside a ``max(0, ·)``
clamp and ``plio_bits_per_cycle`` inside a ceiling denominator — both
nonlinear — so they stay frozen and are folded into the base.

End-to-end totals alone leave one structural null direction: every chain
satisfies ``coef(l_o) − coef(o_cas) − coef(l_init) = 1`` (L layers, L−1
edges) while ``coef(plio_init) = 2`` (two endpoints) — per-design
*constants* that no shape grid can separate. The fit therefore also
conditions on the simulator's **per-stage occupancies**
(:meth:`repro_torch.sim.run.SimResult.stage_occupancy_cycles`): the shim stage
observes ``plio_init`` in isolation, each comm stage observes
``o_cas`` / ``l_init + dma_hop·D``, each comp stage the layer constants —
making all of :data:`FIT_PARAMS` identifiable.

Today the measured side is Tier-S, which prices with the same formulas, so
the fit recovers the frozen constants to float precision and R² ≈ 1 — the
harness is a regression tripwire for the whole model → simulator pipeline
(any re-pricing on either side breaks the fit and fails the CI gate).
When a higher-fidelity backend or real VEK280 traces land, the same
harness re-fits the constants against them, and the per-stage drift path
(:data:`STAGE_SUSPECTS`, :meth:`repro_torch.obs.DriftMonitor.localize`) names
which constants moved.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import aie_arch
from .aie_arch import OverheadParams, OVERHEADS
from .layerspec import LayerSpec, ModelSpec, deepsets, mlp
from .mapping import Mapping, ModelMapping
from .placement import Placement, place
from .perfmodel import end_to_end_cycles, pipeline_stages

#: Constants the end-to-end model is affine in — the fit set. Order fixes
#: the design-matrix columns.
FIT_PARAMS: Tuple[str, ...] = (
    "l_o", "l_o_store_dma", "l_epi", "l_cas", "o_cas",
    "l_init", "dma_hop", "plio_init", "agg_fixed", "agg_per_aie",
)

#: Which overhead constants are priced into each pipeline-stage class —
#: the lookup :meth:`repro_torch.obs.DriftMonitor.localize` hands back to a
#: human: a drifted ``model.stage.shim`` entry implicates the PLIO
#: constants, not the DMA ones.
STAGE_SUSPECTS: Dict[str, Tuple[str, ...]] = {
    "shim": ("plio_init",),
    "comp": ("l_o", "l_o_store_dma", "l_epi", "l_cas",
             "agg_fixed", "agg_per_aie"),
    "comm": ("o_cas", "l_init", "dma_hop"),
}

#: Sweep family names (the per-family R²/MAPE rows of the report).
FAMILIES: Tuple[str, ...] = ("single_aie", "cascade", "dma", "agg")


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One placed design of the calibration sweep."""

    name: str
    family: str
    placement: Placement


def _shim_cap_ok(pl: Placement) -> bool:
    """True when the shim bandwidth cap does not bind on either direction.

    Inside the cap, the analytic serial latency and the Tier-S simulated
    one agree exactly; past it the analytic Eq. (1)-(6) PLIO terms are
    documented-optimistic (see ``initiation_interval_cycles``), so
    cap-binding designs would poison the fit with known model error.
    """
    maps = pl.model_mapping.mappings
    lo = min(r.c0 for r in pl.rects)
    hi = max(r.c0 + r.w for r in pl.rects)
    cap = (hi - lo) * aie_arch.SHIM_STREAMS_PER_COL
    return (maps[0].A * maps[0].B <= cap
            and maps[-1].A * maps[-1].C <= cap)


def _single_layer_point(name: str, family: str, M: int, K: int, N: int, *,
                        A: int = 1, B: int = 1, C: int = 1,
                        bias_relu: bool = False) -> Optional[SweepPoint]:
    layer = LayerSpec(kind="mm", M=M, K=K, N=N, bias=bias_relu,
                      relu=bias_relu, name=name)
    model = ModelSpec((layer,), name=name)
    mm = ModelMapping(model=model,
                      mappings=(Mapping(A=A, B=B, C=C, layer=layer),))
    pl = place(mm, aie_arch.ARRAY_ROWS, aie_arch.ARRAY_COLS)
    if pl is None or not _shim_cap_ok(pl):
        return None
    return SweepPoint(name, family, pl)


def _chain_point(name: str, family: str, model: ModelSpec,
                 splits: Sequence[Tuple[int, int, int]]
                 ) -> Optional[SweepPoint]:
    maps = tuple(Mapping(A=a, B=b, C=c, layer=l)
                 for (a, b, c), l in zip(splits, model.layers))
    mm = ModelMapping(model=model, mappings=maps)
    if not mm.fits():
        return None
    pl = place(mm, aie_arch.ARRAY_ROWS, aie_arch.ARRAY_COLS)
    if pl is None or not _shim_cap_ok(pl):
        return None
    return SweepPoint(name, family, pl)


def default_sweep(families: Optional[Sequence[str]] = None, *,
                  smoke: bool = False) -> List[SweepPoint]:
    """The standard shape grid, a few dozen placed designs per family.

    * ``single_aie`` — Table-2-style 1x1x1 single kernels over an
      (M, K, N) grid: identifies ``l_o``/``l_o_store_dma``/``l_epi``
      (coefficients 1, H1·W2, njl all vary independently).
    * ``cascade`` — B>1 chains whose edges cascade: adds ``l_cas``
      ((njl+B-1)-weighted) and ``o_cas`` (per-edge), with 2- and 3-layer
      chains so per-edge and per-layer constants separate.
    * ``dma`` — chains whose mappings break cascade compatibility (C>1 or
      row mismatch): adds ``l_init``/``dma_hop`` with varying Manhattan
      distances and transfer sizes.
    * ``agg`` — DeepSets-style models over (M, F, A): adds
      ``agg_fixed``/``agg_per_aie``.

    Layer counts 1/2/3 across families also separate the per-design
    ``plio_init`` (always two endpoints) from the per-layer ``l_o``.
    ``smoke=True`` keeps ~1/3 of the grid (CI-sized, still full rank).
    """
    want = set(families or FAMILIES)
    pts: List[SweepPoint] = []

    if "single_aie" in want:
        sizes = ([16, 32, 64] if smoke else [16, 32, 48, 64, 96, 128])
        for m, k, n in itertools.product(sizes, repeat=3):
            if smoke and (m, k, n) not in {(16, 16, 16), (32, 32, 32),
                                           (64, 64, 64), (16, 32, 64),
                                           (64, 32, 16), (32, 64, 32)}:
                continue
            if not smoke and len({m, k, n}) == 3 and (m + k + n) % 64:
                continue   # thin the full cube, keep the mixed-shape corners
            pt = _single_layer_point(f"mm{m}x{k}x{n}", "single_aie", m, k, n)
            if pt is not None:
                pts.append(pt)

    if "cascade" in want:
        grid = ([(32, [32, 32], 2), (64, [64, 64], 4)] if smoke else
                [(32, [32, 32], 2), (32, [64, 32], 2), (64, [64, 64], 2),
                 (64, [64, 64], 4), (64, [128, 64], 4),
                 (32, [32, 32, 32], 2), (64, [64, 64, 64], 2)])
        for mdim, nodes, b in grid:
            model = mlp(mdim, nodes[0], nodes, bias=False, relu=False,
                        name=f"cas{mdim}x{'x'.join(map(str, nodes))}b{b}")
            splits = [(1, b, 1)] * len(nodes)
            pt = _chain_point(model.name, "cascade", model, splits)
            if pt is not None:
                pts.append(pt)

    if "dma" in want:
        grid = ([(32, [32, 32], (1, 1, 2)), (64, [64, 64], (2, 1, 2))]
                if smoke else
                [(32, [32, 32], (1, 1, 2)), (64, [64, 64], (1, 1, 2)),
                 (64, [64, 64], (2, 1, 2)), (64, [128, 128], (1, 2, 2)),
                 (32, [64, 64, 32], (1, 1, 2)), (64, [64, 64, 64], (2, 1, 2))])
        for mdim, nodes, (a, b, c) in grid:
            model = mlp(mdim, nodes[0], nodes, bias=False, relu=False,
                        name=(f"dma{mdim}x{'x'.join(map(str, nodes))}"
                              f"s{a}.{b}.{c}"))
            # C > 1 on every layer breaks cascade compatibility, forcing
            # DMA on each edge with placement-real Manhattan distances.
            splits = [(a, b, c)] * len(nodes)
            pt = _chain_point(model.name, "dma", model, splits)
            if pt is not None:
                pts.append(pt)

    if "agg" in want:
        grid = ([(32, 32, 2), (64, 64, 4)] if smoke else
                [(32, 32, 2), (32, 32, 4), (32, 64, 4), (64, 32, 4),
                 (64, 64, 4), (64, 64, 8)])
        for mdim, f, a in grid:
            model = deepsets(mdim, f, [f], [f], name=f"agg{mdim}x{f}a{a}")
            splits = [(a, 1, 1), (a, 1, 1), (1, 1, 1)]
            pt = _chain_point(model.name, "agg", model, splits)
            if pt is not None:
                pts.append(pt)

    return pts


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------

def _zeroed(base: OverheadParams = OVERHEADS) -> OverheadParams:
    return dataclasses.replace(base, **{k: 0.0 for k in FIT_PARAMS})


def predict_cycles(points: Sequence[SweepPoint],
                   p: OverheadParams = OVERHEADS) -> np.ndarray:
    """Analytic end-to-end cycles of every sweep point under ``p``."""
    return np.array([end_to_end_cycles(pt.placement, p=p).total
                     for pt in points])


def _response(points: Sequence[SweepPoint], p: OverheadParams,
              stage_names: Sequence[Sequence[str]]) -> np.ndarray:
    """Model response vector: end-to-end totals, then the selected
    per-stage occupancies of each point (fixed ordering)."""
    vals = [end_to_end_cycles(pt.placement, p=p).total for pt in points]
    for pt, names in zip(points, stage_names):
        if not names:
            continue
        st = {s.name: s.cycles
              for s in pipeline_stages(pt.placement, p=p).stages}
        vals.extend(st[n] for n in names)
    return np.array(vals)


def design_matrix(points: Sequence[SweepPoint], *,
                  base_params: OverheadParams = OVERHEADS,
                  stage_names: Optional[Sequence[Sequence[str]]] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``(A, base)`` with ``response(θ) = base + A @ θ`` exactly.

    Column k is the model's response to unit constant k (the rest of the
    fit set zeroed, the frozen nonlinear constants kept from
    ``base_params``) — the generic affine-probe construction described in
    the module docstring. ``stage_names`` (per point) appends the named
    per-stage occupancies as additional observation rows.
    """
    if stage_names is None:
        stage_names = [[] for _ in points]
    zero = _zeroed(base_params)
    base = _response(points, zero, stage_names)
    cols = []
    for k in FIT_PARAMS:
        probe = dataclasses.replace(zero, **{k: 1.0})
        cols.append(_response(points, probe, stage_names) - base)
    return np.stack(cols, axis=1), base


def _r2(measured: np.ndarray, predicted: np.ndarray) -> float:
    ss_res = float(np.sum((measured - predicted) ** 2))
    ss_tot = float(np.sum((measured - measured.mean()) ** 2))
    if ss_tot <= 0.0:
        return 1.0 if ss_res <= 1e-9 else 0.0
    return 1.0 - ss_res / ss_tot


def _mape(measured: np.ndarray, predicted: np.ndarray) -> float:
    denom = np.maximum(np.abs(measured), 1e-12)
    return float(np.mean(np.abs(predicted - measured) / denom))


@dataclasses.dataclass
class FamilyFit:
    """Per-kernel-family fit quality (one row of the fig9-style report)."""

    family: str
    n_points: int
    r2: float
    mape: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CalibrationReport:
    """Fitted constants + fit quality, overall and per family."""

    fitted: OverheadParams
    params: Dict[str, Dict[str, float]]   #: name -> {fitted, frozen, rel_err}
    overall_r2: float
    overall_mape: float
    families: Dict[str, FamilyFit]
    n_points: int

    def as_dict(self) -> dict:
        return {
            "n_points": self.n_points,
            "overall_r2": self.overall_r2,
            "overall_mape": self.overall_mape,
            "families": {k: v.as_dict() for k, v in self.families.items()},
            "params": self.params,
        }

    def gate_errors(self, *, mape_max: float = 0.10,
                    r2_min: float = 0.99) -> List[str]:
        """CI gate: overall R² and per-family MAPE thresholds (empty=pass)."""
        errs: List[str] = []
        if self.overall_r2 < r2_min:
            errs.append(f"overall R² {self.overall_r2:.6f} < {r2_min}")
        for fam, fit in self.families.items():
            if fit.mape > mape_max:
                errs.append(f"family {fam}: MAPE {fit.mape:.2%} > "
                            f"{mape_max:.0%}")
        return errs


def fit(points: Sequence[SweepPoint], measured: Sequence[float], *,
        stage_measured: Optional[Sequence[Dict[str, float]]] = None,
        base_params: OverheadParams = OVERHEADS) -> CalibrationReport:
    """Least-squares-fit the affine constants to ``measured`` cycles.

    ``stage_measured`` (one dict per point, stage name → occupancy cycles
    as returned by ``SimResult.stage_occupancy_cycles``) adds per-stage
    observation rows, which makes the full fit set identifiable (see the
    module docstring). Report quality (R²/MAPE) is computed on the
    end-to-end rows only.
    """
    measured = np.asarray(measured, dtype=np.float64)
    n = len(points)
    stage_names: List[List[str]] = [[] for _ in points]
    extra: List[float] = []
    if stage_measured is not None:
        for i, (pt, meas) in enumerate(zip(points, stage_measured)):
            analytic = [s.name for s in
                        pipeline_stages(pt.placement, p=base_params).stages]
            stage_names[i] = [nm for nm in analytic if nm in meas]
            extra.extend(meas[nm] for nm in stage_names[i])
    y = np.concatenate([measured, np.asarray(extra, dtype=np.float64)])
    A, base = design_matrix(points, base_params=base_params,
                            stage_names=stage_names)
    theta, *_ = np.linalg.lstsq(A, y - base, rcond=None)
    fitted = dataclasses.replace(_zeroed(base_params),
                                 **dict(zip(FIT_PARAMS, map(float, theta))))
    predicted = (base + A @ theta)[:n]
    params = {}
    for name, value in zip(FIT_PARAMS, theta):
        frozen = getattr(base_params, name)
        rel = abs(float(value) - frozen) / max(abs(frozen), 1e-9)
        params[name] = {"fitted": float(value), "frozen": float(frozen),
                        "rel_err": rel}
    fams: Dict[str, FamilyFit] = {}
    fam_names = sorted({pt.family for pt in points})
    for fam in fam_names:
        idx = np.array([i for i, pt in enumerate(points)
                        if pt.family == fam])
        fams[fam] = FamilyFit(family=fam, n_points=len(idx),
                              r2=_r2(measured[idx], predicted[idx]),
                              mape=_mape(measured[idx], predicted[idx]))
    return CalibrationReport(
        fitted=fitted, params=params,
        overall_r2=_r2(measured, predicted),
        overall_mape=_mape(measured, predicted),
        families=fams, n_points=len(points))


# ---------------------------------------------------------------------------
# The harness: sweep Tier-S, fit, wire into telemetry + drift
# ---------------------------------------------------------------------------

def run_calibration(families: Optional[Sequence[str]] = None, *,
                    smoke: bool = False, events: int = 1,
                    p: OverheadParams = OVERHEADS,
                    registry=None, monitor=None, engine: str = "fast"):
    """Sweep → simulate → fit → report, with telemetry and drift wiring.

    ``engine`` selects the Tier-S measurement engine (default the compiled
    replay fast path, :mod:`repro_torch.sim.fastpath` — both the latencies and
    the per-stage occupancies it measures are bit-exact with the DES, so
    fits and drift entries are unchanged; pass ``"des"`` to force the full
    event-driven simulator).

    Returns ``(report, registry, monitor, stage_drift_count)``:

    * ``registry`` gains the ``calib.*`` gauges (see :mod:`repro_torch.obs`):
      ``calib.fit.r2{family}`` / ``calib.fit.mape{family}`` (+ the
      ``family="overall"`` rollup) and ``calib.param.value{param}``.
    * ``monitor`` gains one ``calib.param`` entry per constant (expect =
      frozen value, observe = fitted value — ``localize(0.0,
      prefix="calib.param")`` ranks the constants by how far the fit moved
      them) and per-stage ``model.stage.{shim|comp|comm}`` entries
      comparing every design's analytic pipeline stages against the
      simulator's measured per-stage occupancy.
    """
    from repro_torch.obs import DriftMonitor, MetricsRegistry
    from repro_torch.sim.run import SimConfig, sweep_latency_cycles

    reg = registry if registry is not None else MetricsRegistry()
    mon = monitor if monitor is not None else DriftMonitor()
    points = default_sweep(families, smoke=smoke)
    cfg = SimConfig(events=events, trace=False)
    measured, stage_meas = sweep_latency_cycles(
        [pt.placement for pt in points], p=p, config=cfg, stages=True,
        engine=engine)
    report = fit(points, measured, stage_measured=stage_meas, base_params=p)

    for fam, ff in report.families.items():
        reg.gauge("calib.fit.r2", {"family": fam}).set(ff.r2)
        reg.gauge("calib.fit.mape", {"family": fam}).set(ff.mape)
    reg.gauge("calib.fit.r2", {"family": "overall"}).set(report.overall_r2)
    reg.gauge("calib.fit.mape",
              {"family": "overall"}).set(report.overall_mape)
    reg.gauge("calib.sweep.points").set(float(report.n_points))
    for name, rec in report.params.items():
        reg.gauge("calib.param.value", {"param": name}).set(rec["fitted"])
        mon.expect(name, "calib.param", rec["frozen"])
        mon.observe(name, "calib.param", rec["fitted"])

    # Per-stage drift: analytic stage expectation vs simulated occupancy.
    for pt, meas in zip(points, stage_meas):
        for stage in pipeline_stages(pt.placement, p=p).stages:
            got = meas.get(stage.name)
            if got is None:
                continue
            metric = f"model.stage.{stage.kind}"
            mon.expect(f"{pt.name}/{stage.name}", metric, stage.cycles)
            mon.observe(f"{pt.name}/{stage.name}", metric, got)
    stage_drift = len(mon.localize(1e-6))
    reg.gauge("calib.stage.drifted").set(float(stage_drift))
    return report, reg, mon, stage_drift
