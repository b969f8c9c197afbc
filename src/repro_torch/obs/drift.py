"""Model-vs-measured drift monitoring (fig9-style error accounting).

For every ``(key, metric)`` pair — e.g. ``("deepsets-32#0",
"serve.latency_us")`` — the monitor stores one *modeled* reference and a
stream of *measurements*, then reports ``ratio = measured_mean / modeled``
per entry and a MAPE (mean absolute percentage error) per metric. See the
:mod:`repro_torch.obs` docstring for the two metric families (``model.*`` is the
CI-gateable Tier-A-vs-Tier-S path; ``serve.*`` tracks wall-clock serving
against the modeled hardware numbers).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class DriftEntry:
    """One (key, metric) comparison: modeled reference vs measured stream."""

    key: str
    metric: str
    modeled: Optional[float] = None
    count: int = 0
    total: float = 0.0
    last: Optional[float] = None

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += float(value)
        self.last = float(value)

    @property
    def measured(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    @property
    def ratio(self) -> Optional[float]:
        """measured_mean / modeled; 1.0 = perfect agreement."""
        if self.modeled is None or not self.modeled or self.measured is None:
            return None
        return self.measured / self.modeled

    @property
    def ape(self) -> Optional[float]:
        """|measured - modeled| / modeled (absolute percentage error)."""
        r = self.ratio
        return None if r is None else abs(r - 1.0)

    def as_dict(self) -> dict:
        return {"modeled": self.modeled, "measured": self.measured,
                "ratio": self.ratio, "ape": self.ape, "n": self.count}


class DriftMonitor:
    """Streaming modeled-vs-measured comparison across keys and metrics."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[str, str], DriftEntry] = {}

    def _entry(self, key: str, metric: str) -> DriftEntry:
        k = (str(key), str(metric))
        e = self._entries.get(k)
        if e is None:
            e = self._entries[k] = DriftEntry(key=k[0], metric=k[1])
        return e

    def expect(self, key: str, metric: str, modeled: float) -> None:
        """Register (or refresh) the model's prediction for (key, metric)."""
        self._entry(key, metric).modeled = float(modeled)

    def observe(self, key: str, metric: str, value: float) -> None:
        """Stream one measurement in (mean is compared against the model)."""
        self._entry(key, metric).observe(value)

    # -- queries ---------------------------------------------------------------
    def entries(self, metric: Optional[str] = None) -> List[DriftEntry]:
        return [e for (_, m), e in sorted(self._entries.items())
                if metric is None or m == metric]

    def ratio(self, key: str, metric: str) -> Optional[float]:
        e = self._entries.get((str(key), str(metric)))
        return None if e is None else e.ratio

    def metrics(self) -> List[str]:
        return sorted({m for _, m in self._entries})

    def mape(self, metric: Optional[str] = None) -> Optional[float]:
        """Mean |measured/modeled - 1| over populated entries (None when no
        entry has both sides)."""
        apes = [e.ape for e in self.entries(metric) if e.ape is not None]
        return sum(apes) / len(apes) if apes else None

    def family_mape(self, prefix: str) -> Optional[float]:
        """MAPE across every entry whose metric starts with ``prefix``.

        The family-level aggregate for gates that span several metrics of
        one comparison — e.g. ``family_mape("model.blame.")`` pools the
        per-category blame-share entries into the single number the
        ``--blame-gate`` CI step thresholds, mirroring how :meth:`mape`
        gates one metric.
        """
        apes = [e.ape for (_, m), e in sorted(self._entries.items())
                if m.startswith(prefix) and e.ape is not None]
        return sum(apes) / len(apes) if apes else None

    def flagged(self, threshold: float,
                metric: Optional[str] = None) -> List[DriftEntry]:
        """Entries whose drift exceeds ``threshold`` (|ratio - 1|)."""
        return [e for e in self.entries(metric)
                if e.ape is not None and e.ape > threshold]

    def localize(self, threshold: float, prefix: str = "model.stage."
                 ) -> List[DriftEntry]:
        """Drifted entries under a metric-name prefix, worst first.

        The localization counterpart of :meth:`mape`: where the total
        latency/II drift says *that* the model moved, the per-stage entries
        (metrics ``model.stage.shim`` / ``model.stage.comp`` /
        ``model.stage.comm``, one key per pipeline stage of each design)
        say *where* — which narrows the drift to the overhead constants
        priced into that stage class (see
        :data:`repro_torch.core.calibrate.STAGE_SUSPECTS`). Use
        ``prefix="calib.param"`` to rank the fitted-vs-frozen constants
        themselves after a calibration run.
        """
        hits = [e for (_, m), e in self._entries.items()
                if m.startswith(prefix)
                and e.ape is not None and e.ape > threshold]
        return sorted(hits, key=lambda e: -(e.ape or 0.0))

    def summary(self, *, flag_threshold: float = 0.10) -> dict:
        """fig9-style report: per-metric MAPE + per-entry ratios.

        Each per-metric dict additionally carries ``flagged`` — the keys
        whose individual drift exceeds ``flag_threshold`` (worst first) —
        and, for ``model.stage.*`` metrics, ``suspects``: the overhead
        constants :data:`repro_torch.core.calibrate.STAGE_SUSPECTS` prices into
        that stage class, i.e. the :meth:`localize` output a gate failure
        should print instead of a bare MAPE.
        """
        per_metric: Dict[str, dict] = {}
        for m in self.metrics():
            flagged = sorted(self.flagged(flag_threshold, m),
                             key=lambda e: -(e.ape or 0.0))
            d: Dict[str, object] = {
                "mape": self.mape(m),
                "entries": {e.key: e.as_dict() for e in self.entries(m)},
                "flagged": [e.key for e in flagged]}
            if flagged and m.startswith("model.stage."):
                from repro_torch.core.calibrate import STAGE_SUSPECTS
                stage = m[len("model.stage."):]
                d["suspects"] = list(STAGE_SUSPECTS.get(stage, ()))
            per_metric[m] = d
        return per_metric
