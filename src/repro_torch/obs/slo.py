"""Per-tenant SLO accounting: error budgets, burn rates, multi-window alerts.

The trigger-application contract is not "as fast as possible" — it is
"fraction ``availability`` of events classified within ``p99`` budget"
(arXiv:1903.10201: a fixed latency budget under relentless offered rates).
This module turns the streaming latency measurements the fleet and the
simulator already emit into that contract's bookkeeping:

  * :class:`SLOSpec` — the target: a latency budget in ns plus the
    availability fraction that must meet it. The *error budget* is the
    complementary fraction ``1 - availability`` of events allowed to miss.
  * :class:`SLOTracker` — deterministic, time-bucketed good/bad accounting.
    Every recorded event is *good* (latency <= budget, admitted) or *bad*
    (late, or shed by admission control). Burn rate over a window is
    ``bad_fraction / (1 - availability)``: 1.0 means the budget is being
    consumed exactly at the sustainable rate, N means N times too fast.
  * Multi-window burn alerts (:class:`BurnWindow`, :class:`BurnAlert`) —
    an alert fires only when *both* a long and a short window exceed the
    threshold: the long window gives significance, the short window makes
    the alert reset quickly once the cause is fixed (the standard SRE
    multi-window, multi-burn-rate construction).
  * :class:`SLOReport` — JSON-able roll-up across tenants; the
    ``launch.serve --slo-report-out`` artifact, and the input of the
    budget-exhaustion exit gate.

All timestamps are caller-supplied seconds on an arbitrary monotonic
clock (wall seconds for the fleet, simulated seconds for the DES), so
tests and replays are fully deterministic — nothing here reads the system
clock unless the caller omits ``t``.

Metrics emitted into a :class:`repro_torch.obs.MetricsRegistry` (optional):

  ``slo.requests.good`` / ``slo.requests.bad``  counter {tenant}
  ``slo.burn_rate``                gauge {tenant, window} — refreshed on
                                   :meth:`SLOTracker.snapshot`
  ``slo.error_budget.remaining``   gauge {tenant} — fraction of the
                                   accounting window's budget left (can go
                                   negative: overspend)
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One tenant's latency SLO.

    ``p99_latency_budget_ns`` is the per-event budget; ``availability``
    the fraction of events that must meet it (0.99 makes the budget a p99
    in the literal sense). ``window_s`` is the error-budget accounting
    horizon — the "month" of the SRE formulation, shrunk to something a
    benchmark run can exhaust.
    """

    tenant: str
    p99_latency_budget_ns: float
    availability: float = 0.99
    window_s: float = 60.0

    def __post_init__(self) -> None:
        if self.p99_latency_budget_ns <= 0:
            raise ValueError(f"SLO {self.tenant!r}: latency budget must be "
                             f"> 0, got {self.p99_latency_budget_ns}")
        if not 0.0 < self.availability < 1.0:
            raise ValueError(f"SLO {self.tenant!r}: availability must be in "
                             f"(0, 1), got {self.availability}")
        if self.window_s <= 0:
            raise ValueError(f"SLO {self.tenant!r}: window must be > 0")

    @property
    def error_budget(self) -> float:
        """Allowed bad fraction: 1 - availability."""
        return 1.0 - self.availability

    def as_dict(self) -> dict:
        return {"tenant": self.tenant,
                "p99_latency_budget_ns": self.p99_latency_budget_ns,
                "availability": self.availability,
                "window_s": self.window_s}


def parse_slo(text: str, tenants: Sequence[str], *,
              budget_scale_ns: float = 1e3,
              window_s: float = 60.0) -> Dict[str, SLOSpec]:
    """Parse the ``--slo`` grammar into per-tenant specs.

    Two forms, comma-separable::

        <budget>[:<availability>]                  # applies to every tenant
        <tenant>=<budget>[:<availability>]         # one tenant

    ``budget_scale_ns`` converts the CLI number to ns — the serving driver
    passes 1e3 (budgets typed in us, the wall-clock unit its percentiles
    print in); cycle-clock callers pass 1.0 for ns.
    """
    out: Dict[str, SLOSpec] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, rhs = part.partition("=")
        if not eq:
            name, rhs = "", part
        else:
            name = name.strip()
            if name not in tenants:
                raise ValueError(f"--slo names unknown tenant {name!r} "
                                 f"(tenants: {list(tenants)})")
        budget_s, _, avail_s = rhs.partition(":")
        try:
            budget = float(budget_s) * budget_scale_ns
            avail = float(avail_s) if avail_s else 0.99
        except ValueError:
            raise ValueError(f"bad --slo clause {part!r}: expected "
                             f"[tenant=]<budget>[:<availability>]") from None
        for t in ([name] if name else tenants):
            out[t] = SLOSpec(tenant=t, p99_latency_budget_ns=budget,
                             availability=avail, window_s=window_s)
    if not out:
        raise ValueError(f"empty --slo spec {text!r}")
    return out


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate alert rule.

    Fires when the burn rate over *both* ``long_s`` and ``short_s``
    exceeds ``threshold``. The default pair below is the classic page/
    ticket ladder rescaled to a 60 s budget window (long = window/12,
    short = window/60).
    """

    long_s: float
    short_s: float
    threshold: float
    severity: str = "page"


#: Default ladder for a ``window_s``-second budget: fast burn pages,
#: slow burn tickets. Fractions of the accounting window, so the ladder
#: rescales with the SLO instead of hard-coding SRE's 30-day month.
def default_burn_windows(window_s: float) -> Tuple[BurnWindow, ...]:
    return (BurnWindow(long_s=window_s / 12.0, short_s=window_s / 60.0,
                       threshold=14.4, severity="page"),
            BurnWindow(long_s=window_s / 4.0, short_s=window_s / 12.0,
                       threshold=6.0, severity="page"),
            BurnWindow(long_s=window_s, short_s=window_s / 4.0,
                       threshold=1.0, severity="ticket"))


@dataclasses.dataclass(frozen=True)
class BurnAlert:
    """One fired alert: both windows of the rule exceeded the threshold."""

    tenant: str
    severity: str
    threshold: float
    long_s: float
    short_s: float
    burn_long: float
    burn_short: float
    at_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class SLOTracker:
    """Streaming good/bad accounting for one tenant's SLO.

    Events land in fixed-width time buckets (a ring is unnecessary: the
    bucket dict is pruned to the accounting window on every record), so
    window queries are O(window / bucket) and results depend only on the
    recorded ``(latency, t)`` stream — never on the host clock.
    """

    def __init__(self, spec: SLOSpec, *, registry=None,
                 burn_windows: Optional[Sequence[BurnWindow]] = None,
                 bucket_s: Optional[float] = None) -> None:
        self.spec = spec
        self.burn_windows = tuple(burn_windows if burn_windows is not None
                                  else default_burn_windows(spec.window_s))
        shortest = min([w.short_s for w in self.burn_windows]
                       + [spec.window_s])
        self.bucket_s = bucket_s if bucket_s is not None else shortest / 4.0
        if self.bucket_s <= 0:
            raise ValueError("bucket_s must be > 0")
        self._buckets: Dict[int, List[int]] = {}   # idx -> [good, bad]
        self.good = 0
        self.bad = 0
        self.shed = 0
        self._last_t: Optional[float] = None
        self._m_good = self._m_bad = None
        if registry is not None:
            labels = {"tenant": spec.tenant}
            self._m_good = registry.counter("slo.requests.good", labels)
            self._m_bad = registry.counter("slo.requests.bad", labels)
        self._registry = registry

    # -- recording -----------------------------------------------------------
    def _now(self, t: Optional[float]) -> float:
        return time.monotonic() if t is None else float(t)

    def record(self, latency_ns: float, t: Optional[float] = None) -> bool:
        """Record one completed event; returns True when it met the budget."""
        good = latency_ns <= self.spec.p99_latency_budget_ns
        self._record(good, self._now(t))
        return good

    def record_shed(self, t: Optional[float] = None) -> None:
        """An event the admission control dropped: always budget-bad."""
        self.shed += 1
        self._record(False, self._now(t))

    def _record(self, good: bool, t: float) -> None:
        idx = int(t // self.bucket_s)
        b = self._buckets.get(idx)
        if b is None:
            b = self._buckets[idx] = [0, 0]
            # prune buckets older than every window we can be asked about
            horizon = idx - int(self.spec.window_s / self.bucket_s) - 1
            for k in [k for k in self._buckets if k < horizon]:
                del self._buckets[k]
        b[0 if good else 1] += 1
        if good:
            self.good += 1
            if self._m_good is not None:
                self._m_good.inc()
        else:
            self.bad += 1
            if self._m_bad is not None:
                self._m_bad.inc()
        self._last_t = t if self._last_t is None else max(self._last_t, t)

    # -- windowed queries ----------------------------------------------------
    def _window_counts(self, window_s: float, now: float) -> Tuple[int, int]:
        lo = now - window_s
        good = bad = 0
        for idx, (g, b) in self._buckets.items():
            # bucket midpoint decides membership: cheap and deterministic
            mid = (idx + 0.5) * self.bucket_s
            if lo < mid <= now + 0.5 * self.bucket_s:
                good += g
                bad += b
        return good, bad

    def bad_fraction(self, window_s: float,
                     now: Optional[float] = None) -> float:
        g, b = self._window_counts(window_s, self._resolve_now(now))
        return b / (g + b) if (g + b) else 0.0

    def burn_rate(self, window_s: float,
                  now: Optional[float] = None) -> float:
        """bad_fraction / error_budget over the window (1.0 = sustainable)."""
        return self.bad_fraction(window_s, now) / self.spec.error_budget

    def error_budget_remaining(self, now: Optional[float] = None) -> float:
        """Fraction of the accounting window's error budget still unspent.

        1.0 = untouched, 0.0 = exactly exhausted, negative = overspent.
        """
        return 1.0 - self.burn_rate(self.spec.window_s, now)

    def exhausted(self, now: Optional[float] = None) -> bool:
        return self.error_budget_remaining(now) <= 0.0

    def alerts(self, now: Optional[float] = None) -> List[BurnAlert]:
        """Fired multi-window alerts at ``now`` (deterministic, stateless)."""
        t = self._resolve_now(now)
        out: List[BurnAlert] = []
        for w in self.burn_windows:
            bl = self.burn_rate(w.long_s, t)
            bs = self.burn_rate(w.short_s, t)
            if bl >= w.threshold and bs >= w.threshold:
                out.append(BurnAlert(tenant=self.spec.tenant,
                                     severity=w.severity,
                                     threshold=w.threshold,
                                     long_s=w.long_s, short_s=w.short_s,
                                     burn_long=bl, burn_short=bs, at_s=t))
        return out

    def _resolve_now(self, now: Optional[float]) -> float:
        if now is not None:
            return float(now)
        return self._last_t if self._last_t is not None else 0.0

    # -- export --------------------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> dict:
        t = self._resolve_now(now)
        alerts = self.alerts(t)
        remaining = self.error_budget_remaining(t)
        if self._registry is not None:
            labels = {"tenant": self.spec.tenant}
            self._registry.gauge("slo.error_budget.remaining",
                                 labels).set(remaining)
            for w in self.burn_windows:
                self._registry.gauge(
                    "slo.burn_rate",
                    {**labels, "window": f"{w.long_s:g}s"}
                ).set(self.burn_rate(w.long_s, t))
        return {"spec": self.spec.as_dict(),
                "good": self.good, "bad": self.bad, "shed": self.shed,
                "bad_fraction_window": self.bad_fraction(self.spec.window_s,
                                                         t),
                "burn_rate_window": self.burn_rate(self.spec.window_s, t),
                "error_budget_remaining": remaining,
                "exhausted": self.exhausted(t),
                "alerts": [a.as_dict() for a in alerts]}


@dataclasses.dataclass
class SLOReport:
    """Cross-tenant SLO roll-up: the ``--slo-report-out`` artifact."""

    tenants: Dict[str, dict]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_trackers(cls, trackers: Dict[str, SLOTracker], *,
                      now: Optional[float] = None,
                      meta: Optional[dict] = None) -> "SLOReport":
        return cls(tenants={name: tr.snapshot(now)
                            for name, tr in sorted(trackers.items())},
                   meta=dict(meta or {}))

    @property
    def exhausted_tenants(self) -> List[str]:
        return [n for n, s in self.tenants.items() if s["exhausted"]]

    @property
    def ok(self) -> bool:
        """True when no tenant's error budget is exhausted."""
        return not self.exhausted_tenants

    def exit_code(self) -> int:
        """The serve driver's ``--slo`` gate: 1 on budget exhaustion."""
        return 0 if self.ok else 1

    def as_dict(self) -> dict:
        return {"ok": self.ok, "exhausted": self.exhausted_tenants,
                "tenants": self.tenants, **({"meta": self.meta}
                                            if self.meta else {})}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)
        return path
