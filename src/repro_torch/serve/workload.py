"""Seeded open-loop arrival generators: the offered-load side of serving.

Every throughput figure the repo produced before this module assumed
*closed-loop* admission: the next event enters exactly when the pipeline
can take it (one event per initiation interval), so queues never form and
measured latency equals the dataflow latency. Real trigger systems are
*open loop* — the detector fires at its own rate regardless of whether the
accelerator is ready (arXiv:1903.10201's fixed p99 budget under relentless
event rates) — and the latency a tenant experiences is dataflow latency
**plus queueing**, which only shows up once arrivals are modeled.

One :class:`ArrivalSpec` drives both execution domains through the same
parser and generator:

  * the Tier-S discrete-event simulator on the **cycle clock**
    (:func:`arrival_cycles` — ``rate_eps`` is events/sec of the modeled
    VEK280, converted to AIE cycles), and
  * the :class:`repro_torch.serve.fleet.FleetServer` on the **wall clock**
    (:func:`drive` — ``rate_eps`` is events/sec of this host).

Spec grammar (the ``--arrivals`` flag of ``launch.serve``)::

    closed                 # no arrival process: admission at completion
    poisson:<eps>          # Poisson arrivals, exponential inter-arrivals
    burst:<eps>:<cv>       # bursty renewal process with target CV
    trace:<file>           # replay absolute timestamps from a file

``burst`` produces a renewal process whose inter-arrival coefficient of
variation matches ``cv``: for ``cv > 1`` a balanced-means two-phase
hyperexponential (the standard MMPP-flavoured burst model — a fast phase
most of the time, a slow phase that opens gaps), for ``cv < 1`` a gamma
(Erlang-like) smoother-than-Poisson process, and ``cv == 1`` reduces
exactly to Poisson. Trace files hold one ascending timestamp (seconds)
per line, or a JSON array of timestamps.

All generators are deterministic under a seed (stdlib ``random``; no
numpy) so DES runs, fleet drives, and CI gates are reproducible.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
import time
from typing import Callable, List, Optional, Sequence, Tuple

ARRIVAL_KINDS = ("closed", "poisson", "burst", "trace")


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One offered-load description, shared by wall-clock and cycle-clock
    drivers.

    ``rate_eps`` is events/sec *in the consumer's clock domain*: modeled
    VEK280 events/sec for the simulator, host events/sec for the fleet.
    ``cv`` is the target coefficient of variation of inter-arrival times
    (only meaningful for ``burst``; Poisson has CV 1 by construction).
    ``timestamps`` holds the replay trace in seconds, ascending from 0.
    """

    kind: str
    rate_eps: float = 0.0
    cv: float = 1.0
    timestamps: Optional[Tuple[float, ...]] = None
    source: str = ""                  #: original spec text / trace path

    def __post_init__(self) -> None:
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r} "
                             f"(choices: {ARRIVAL_KINDS})")
        if self.kind in ("poisson", "burst") and self.rate_eps <= 0:
            raise ValueError(f"{self.kind} arrivals need rate_eps > 0, "
                             f"got {self.rate_eps}")
        if self.kind == "burst" and self.cv <= 0:
            raise ValueError(f"burst arrivals need cv > 0, got {self.cv}")
        if self.kind == "trace":
            ts = self.timestamps
            if not ts:
                raise ValueError("trace arrivals need timestamps")
            if any(b < a for a, b in zip(ts, ts[1:])):
                raise ValueError("trace timestamps must be ascending")
            if ts[0] < 0:
                raise ValueError("trace timestamps must be >= 0")

    @property
    def open_loop(self) -> bool:
        return self.kind != "closed"

    def describe(self) -> str:
        if self.kind == "closed":
            return "closed-loop (admission at completion)"
        if self.kind == "poisson":
            return f"poisson @ {self.rate_eps:g} eps"
        if self.kind == "burst":
            return f"burst @ {self.rate_eps:g} eps, CV {self.cv:g}"
        return (f"trace replay ({len(self.timestamps)} timestamps"
                f"{', ' + self.source if self.source else ''})")

    def as_dict(self) -> dict:
        d = {"kind": self.kind}
        if self.kind in ("poisson", "burst"):
            d["rate_eps"] = self.rate_eps
        if self.kind == "burst":
            d["cv"] = self.cv
        if self.kind == "trace":
            d["n_timestamps"] = len(self.timestamps)
            d["source"] = self.source
        return d


def closed() -> ArrivalSpec:
    return ArrivalSpec(kind="closed")


def poisson(rate_eps: float) -> ArrivalSpec:
    return ArrivalSpec(kind="poisson", rate_eps=rate_eps)


def burst(rate_eps: float, cv: float) -> ArrivalSpec:
    return ArrivalSpec(kind="burst", rate_eps=rate_eps, cv=cv)


def trace(timestamps: Sequence[float], *, source: str = "") -> ArrivalSpec:
    return ArrivalSpec(kind="trace", timestamps=tuple(float(t) for t in
                                                      timestamps),
                       source=source)


def load_trace(path: str) -> ArrivalSpec:
    """Read a replay trace: a JSON array of seconds, or one float per line."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        raise ValueError(f"arrival trace {path!r} is empty")
    if text.lstrip()[0] == "[":
        ts = json.loads(text)
    else:
        ts = [float(line) for line in text.splitlines()
              if line.strip() and not line.lstrip().startswith("#")]
    return trace(ts, source=path)


def parse_arrivals(text: str) -> ArrivalSpec:
    """Parse the shared ``--arrivals`` grammar (see module docstring)."""
    s = text.strip()
    kind, _, rest = s.partition(":")
    kind = kind.lower()
    if kind == "closed":
        if rest:
            raise ValueError(f"closed takes no arguments: {text!r}")
        return closed()
    if kind == "poisson":
        try:
            return poisson(float(rest))
        except ValueError as e:
            raise ValueError(f"bad poisson spec {text!r}: expected "
                             f"poisson:<eps> ({e})") from None
    if kind == "burst":
        rate_s, _, cv_s = rest.partition(":")
        try:
            return burst(float(rate_s), float(cv_s) if cv_s else 2.0)
        except ValueError:
            raise ValueError(f"bad burst spec {text!r}: expected "
                             f"burst:<eps>:<cv>") from None
    if kind == "trace":
        if not rest:
            raise ValueError(f"bad trace spec {text!r}: expected "
                             f"trace:<file>")
        return load_trace(rest)
    raise ValueError(f"unknown arrival kind {kind!r} in {text!r} "
                     f"(choices: {ARRIVAL_KINDS})")


# ---------------------------------------------------------------------------
# Inter-arrival sampling
# ---------------------------------------------------------------------------

def _burst_sampler(rate: float, cv: float,
                   rng: random.Random) -> Callable[[], float]:
    """Renewal-process sampler with mean 1/rate and the target CV.

    ``cv > 1``: balanced-means hyperexponential H2 — with probability
    ``p1`` draw from a fast exponential (rate ``2 p1 λ``), else from a slow
    one (rate ``2 p2 λ``). Balanced means (``p1/λ1 == p2/λ2``) pin both the
    mean and the squared CV exactly:

        p1 = (1 + sqrt((c² − 1) / (c² + 1))) / 2

    This is the classic two-phase burst model: most gaps are short, a
    heavy tail of long silences separates the bursts. ``cv < 1``: gamma
    with shape ``1/c²`` (Erlang-like, smoother than Poisson). ``cv == 1``
    is exactly exponential.
    """
    mean = 1.0 / rate
    c2 = cv * cv
    if abs(c2 - 1.0) < 1e-12:
        return lambda: rng.expovariate(rate)
    if c2 > 1.0:
        p1 = 0.5 * (1.0 + math.sqrt((c2 - 1.0) / (c2 + 1.0)))
        p2 = 1.0 - p1
        l1 = 2.0 * p1 * rate
        l2 = 2.0 * p2 * rate
        return lambda: (rng.expovariate(l1) if rng.random() < p1
                        else rng.expovariate(l2))
    shape = 1.0 / c2
    scale = mean / shape
    return lambda: rng.gammavariate(shape, scale)


def arrival_times(spec: ArrivalSpec, n: int, *,
                  seed: Optional[int] = 0,
                  rng: Optional[random.Random] = None) -> List[float]:
    """Absolute arrival times (seconds, ascending, first >= 0) for n events.

    ``closed`` returns all zeros — the consumer admits at completion and
    the timestamps are unused. Passing an explicit ``rng`` lets one seeded
    stream produce *independent* per-instance/per-tenant arrival
    sequences (each call advances the stream).
    """
    if n <= 0:
        return []
    if spec.kind == "closed":
        return [0.0] * n
    if spec.kind == "trace":
        ts = spec.timestamps
        if len(ts) < n:
            # tile the trace: repeat its span back to back, preserving gaps
            span = ts[-1] + (ts[-1] / max(len(ts) - 1, 1) if len(ts) > 1
                             else 1.0)
            out = []
            for i in range(n):
                rep, j = divmod(i, len(ts))
                out.append(rep * span + ts[j])
            return out
        return list(ts[:n])
    r = rng if rng is not None else random.Random(seed)
    sample = (_burst_sampler(spec.rate_eps, spec.cv, r)
              if spec.kind == "burst"
              else (lambda: r.expovariate(spec.rate_eps)))
    t, out = 0.0, []
    for _ in range(n):
        t += sample()
        out.append(t)
    return out


def arrival_cycles(spec: ArrivalSpec, n: int, *,
                   seed: Optional[int] = 0,
                   rng: Optional[random.Random] = None) -> List[float]:
    """Arrival offsets in AIE cycles for the Tier-S simulator.

    ``spec.rate_eps`` is interpreted as events/sec of the *modeled*
    hardware, so seconds convert through the modeled clock
    (:data:`repro_torch.core.aie_arch.NS_PER_CYCLE`), not the host's.
    """
    from repro_torch.core import aie_arch
    return [aie_arch.cycles_from_ns(t * 1e9)
            for t in arrival_times(spec, n, seed=seed, rng=rng)]


# ---------------------------------------------------------------------------
# Wall-clock fleet driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DriveResult:
    """Outcome of one open-loop drive of a fleet tenant."""

    requests: list                   #: admitted requests, submission order
    admitted_idx: list               #: index into ``xs`` of each admitted
                                     #: request (labels/ground truth join key)
    offered: int
    admitted: int
    shed: int
    wall_s: float
    lag_s: float                     #: how far the driver fell behind the
                                     #: intended arrival schedule (>=0)

    @property
    def offered_eps(self) -> float:
        return self.offered / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> dict:
        return {"offered": self.offered, "admitted": self.admitted,
                "shed": self.shed, "wall_s": self.wall_s,
                "offered_eps": self.offered_eps, "lag_s": self.lag_s}


def drive(fleet, xs: Sequence, spec: ArrivalSpec, *,
          tenant: Optional[str] = None, seed: Optional[int] = 0,
          rng: Optional[random.Random] = None,
          sleep: Callable[[float], None] = time.sleep,
          clock: Callable[[], float] = time.perf_counter) -> DriveResult:
    """Offer ``xs`` to the fleet on the spec's wall-clock schedule.

    Closed-loop specs degenerate to back-to-back offering (the previous
    behaviour). Open-loop specs sleep out each inter-arrival gap and then
    *offer* the event regardless of fleet state — the fleet's admission
    control (:meth:`repro_torch.serve.fleet.FleetServer.offer`) decides whether
    it is admitted or shed, which is what makes offered-vs-admitted a
    meaningful pair of counters. If the host cannot keep up with the
    schedule (kernel launches outlast the gaps), the driver never skips
    events; it runs late and reports the terminal ``lag_s``.
    """
    times = arrival_times(spec, len(xs), seed=seed, rng=rng)
    t0 = clock()
    reqs = []
    idx = []
    offered = admitted = 0
    for i, (x, t_arr) in enumerate(zip(xs, times)):
        if spec.open_loop:
            wait = t0 + t_arr - clock()
            if wait > 0:
                sleep(wait)
        offered += 1
        req = fleet.offer(x, tenant=tenant)
        if req is not None:
            admitted += 1
            reqs.append(req)
            idx.append(i)
    wall = clock() - t0
    lag = max(0.0, wall - (times[-1] if times else 0.0))
    return DriveResult(requests=reqs, admitted_idx=idx, offered=offered,
                       admitted=admitted, shed=offered - admitted,
                       wall_s=wall, lag_s=lag)
