"""Metrics registry: counters, gauges, streaming histograms, exporters.

Dependency-free (stdlib only) so every layer of the stack — simulator,
fleet, DSE, launchers — can emit without caring where the numbers go.
Histograms are *streaming*: a fixed log-spaced bucket vector (exactly
mergeable across replicas) plus P² quantile estimators (Jain & Chlamtac
1985) for accurate rolling percentiles without storing samples. See the
:mod:`repro_torch.obs` module docstring for the metric naming scheme.
"""
from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, object]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def default_buckets() -> Tuple[float, ...]:
    """1-2-5 log series from 1e-3 to 5e9 — wide enough for ns latencies,
    us wall clocks, and events/sec without per-metric tuning."""
    return tuple(c * 10.0 ** e for e in range(-3, 10) for c in (1, 2, 5))


class P2Quantile:
    """Streaming estimate of one quantile via the P² algorithm.

    Five markers track (min, p/2, p, (1+p)/2, max); marker heights adjust
    by parabolic interpolation as observations stream in. O(1) memory,
    no samples retained; accuracy on smooth distributions is well inside
    1% relative once a few thousand observations have been seen.
    """

    __slots__ = ("p", "_n", "_np", "_dn", "_q", "_buf")

    def __init__(self, p: float) -> None:
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = p
        self._buf: List[float] = []      # first <5 observations
        self._q: List[float] = []        # marker heights
        self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._np = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p, 3.0 + 2.0 * p, 5.0]
        self._dn = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        if len(self._buf) < 5 and not self._q:
            self._buf.append(x)
            if len(self._buf) == 5:
                self._q = sorted(self._buf)
            return
        q, n = self._q, self._n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if q[i] <= x < q[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if ((d >= 1.0 and n[i + 1] - n[i] > 1.0)
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0)):
                d = math.copysign(1.0, d)
                qp = q[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (q[i + 1] - q[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1])
                    / (n[i] - n[i - 1]))
                if not q[i - 1] < qp < q[i + 1]:   # parabolic left the order
                    j = i + int(d)
                    qp = q[i] + d * (q[j] - q[i]) / (n[j] - n[i])
                q[i] = qp
                n[i] += d

    @property
    def value(self) -> float:
        if self._q:
            return self._q[2]
        if not self._buf:
            return 0.0
        s = sorted(self._buf)
        idx = self.p * (len(s) - 1)
        lo = int(idx)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (idx - lo) * (s[hi] - s[lo])


class Metric:
    """Common identity: name + frozen labels. Subclasses hold the value."""

    kind = "metric"

    def __init__(self, name: str, labels: LabelKey) -> None:
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    @property
    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelKey) -> None:
        super().__init__(name, labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self.value += n

    def merge(self, other: "Counter") -> None:
        with self._lock:
            self.value += other.value

    def as_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels_dict,
                "value": self.value}


class Gauge(Metric):
    """Last-written value (merge keeps the most recently written side)."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey) -> None:
        super().__init__(name, labels)
        self.value = 0.0
        self.writes = 0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)
            self.writes += 1

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n
            self.writes += 1

    def merge(self, other: "Gauge") -> None:
        with self._lock:
            if other.writes >= self.writes:
                self.value = other.value
            self.writes += other.writes

    def as_dict(self) -> dict:
        return {"name": self.name, "labels": self.labels_dict,
                "value": self.value}


class Histogram(Metric):
    """Streaming distribution: fixed buckets + P² rolling quantiles.

    The bucket vector (cumulative-style ``le`` upper bounds plus a +Inf
    overflow) merges exactly across replicas; the P² estimators give
    accurate local quantiles without samples. A merged histogram has no
    valid P² state, so :meth:`quantile` falls back to linear interpolation
    within the merged buckets (bounded by bucket resolution).
    """

    kind = "histogram"

    def __init__(self, name: str, labels: LabelKey, *,
                 buckets: Optional[Sequence[float]] = None,
                 quantiles: Sequence[float] = (0.5, 0.9, 0.99)) -> None:
        super().__init__(name, labels)
        bs = tuple(sorted(buckets if buckets is not None else default_buckets()))
        if not bs:
            raise ValueError(f"histogram {name}: empty bucket vector")
        self.bounds = bs
        self.bucket_counts = [0] * (len(bs) + 1)   # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.tracked_quantiles = tuple(quantiles)
        self._p2: Optional[Dict[float, P2Quantile]] = {
            q: P2Quantile(q) for q in quantiles}

    def record(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self.count += 1
            self.sum += x
            self.min = x if self.min is None else min(self.min, x)
            self.max = x if self.max is None else max(self.max, x)
            i = self._bucket_index(x)
            self.bucket_counts[i] += 1
            if self._p2 is not None:
                for est in self._p2.values():
                    est.observe(x)

    def _bucket_index(self, x: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if x <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Rolling quantile: the P² estimate when this histogram recorded
        its own stream, the bucket interpolation after a merge."""
        if self.count == 0:
            return 0.0
        if self._p2 is not None and q in self._p2:
            return self._p2[q].value
        return self.bucket_quantile(q)

    def bucket_quantile(self, q: float) -> float:
        """Linear interpolation within the fixed buckets (merge-safe)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = (self.bounds[i - 1] if i > 0
                      else (self.min if self.min is not None else 0.0))
                hi = (self.bounds[i] if i < len(self.bounds)
                      else (self.max if self.max is not None else lo))
                lo = max(lo, self.min) if self.min is not None else lo
                hi = min(hi, self.max) if self.max is not None else hi
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.max if self.max is not None else 0.0

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError(f"histogram {self.name}: incompatible bucket "
                             f"vectors ({len(self.bounds)} vs "
                             f"{len(other.bounds)} bounds)")
        with self._lock:
            self.count += other.count
            self.sum += other.sum
            for i, c in enumerate(other.bucket_counts):
                self.bucket_counts[i] += c
            if other.min is not None:
                self.min = (other.min if self.min is None
                            else min(self.min, other.min))
            if other.max is not None:
                self.max = (other.max if self.max is None
                            else max(self.max, other.max))
            if other.count:
                self._p2 = None    # P² state is not mergeable; see class doc

    def as_dict(self) -> dict:
        d = {"name": self.name, "labels": self.labels_dict,
             "count": self.count, "sum": self.sum, "mean": self.mean,
             "min": self.min, "max": self.max,
             "quantiles": {f"p{round(q * 100):d}": self.quantile(q)
                           for q in self.tracked_quantiles},
             "buckets": [[b, c] for b, c in
                         zip(list(self.bounds) + ["+Inf"],
                             self.bucket_counts) if c]}
        return d


_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PROM_NAME.sub("_", name)


def _prom_labels(labels: Iterable[Tuple[str, str]], extra: str = "") -> str:
    parts = [f'{_prom_name(k)}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Get-or-create metric store, snapshot/merge/export entry point."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], Metric] = {}

    # -- get-or-create ------------------------------------------------------
    def _get(self, cls, name: str, labels: Optional[dict], **kw) -> Metric:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[dict] = None, *,
                  buckets: Optional[Sequence[float]] = None,
                  quantiles: Sequence[float] = (0.5, 0.9, 0.99)) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets,
                         quantiles=quantiles)

    # -- lookups (None when absent; never creates) --------------------------
    def find(self, name: str, labels: Optional[dict] = None) -> Optional[Metric]:
        return self._metrics.get((name, _label_key(labels)))

    def all(self, name: Optional[str] = None) -> List[Metric]:
        return [m for (n, _), m in sorted(self._metrics.items())
                if name is None or n == name]

    # -- merge --------------------------------------------------------------
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry in: counters/histograms add, gauges keep
        the most recently written side. Returns self."""
        for (name, lk), m in other._metrics.items():
            if isinstance(m, Histogram):
                mine = self._get(Histogram, name, dict(lk),
                                 buckets=m.bounds,
                                 quantiles=m.tracked_quantiles)
            else:
                mine = self._get(type(m), name, dict(lk))
            mine.merge(m)
        return self

    # -- exporters -----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric, grouped by kind."""
        out = {"counters": [], "gauges": [], "histograms": []}
        for m in self.all():
            out[m.kind + "s"].append(m.as_dict())
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def save(self, path: str, *, extra: Optional[dict] = None) -> str:
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        with open(path, "w") as f:
            json.dump(snap, f, indent=1)
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition (histogram buckets are cumulative)."""
        lines: List[str] = []
        typed = set()
        for m in self.all():
            pname = _prom_name(m.name)
            if pname not in typed:
                lines.append(f"# TYPE {pname} {m.kind}")
                typed.add(pname)
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.bounds, m.bucket_counts):
                    cum += c
                    le = 'le="%g"' % b
                    lines.append(f"{pname}_bucket"
                                 f"{_prom_labels(m.labels, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(f"{pname}_bucket"
                             f"{_prom_labels(m.labels, inf)} {m.count}")
                lines.append(f"{pname}_sum{_prom_labels(m.labels)} {m.sum:g}")
                lines.append(f"{pname}_count{_prom_labels(m.labels)} "
                             f"{m.count}")
            else:
                lines.append(f"{pname}{_prom_labels(m.labels)} {m.value:g}")
        return "\n".join(lines) + "\n"
