"""Unified telemetry layer: metrics, span tracing, and drift monitoring.

The paper's argument is overhead-aware accounting — synchronization, VLIW
prologue, shim DMA are *priced*, not assumed away. ``repro_torch.obs`` applies
the same discipline to the runtime stack itself: every layer (the Tier-S
simulator, the serving fleet, the DSE) emits into one dependency-free
substrate instead of keeping private ad-hoc counters, and the stack
cross-checks its measurements against the model that packed it.

Three pieces:

  * :class:`MetricsRegistry` (:mod:`repro_torch.obs.metrics`) — named counters,
    gauges, and streaming histograms (fixed log buckets + P² quantile
    estimators), labelled, mergeable across replicas, exported as a JSON
    snapshot or Prometheus text.
  * :class:`Tracer` (:mod:`repro_torch.obs.tracing`) — Chrome-trace span
    recording with stable pid/tid lane conventions. The simulator's
    :class:`repro_torch.sim.trace.ChromeTrace` is a cycle-clock subclass, so
    simulator task spans and fleet wall-clock spans land in one timeline.
  * :class:`DriftMonitor` (:mod:`repro_torch.obs.drift`) — modeled-vs-measured
    comparison: register the model's expectation per key, stream in
    measurements, read back per-key drift ratios and a fig9-style MAPE.

Metrics naming scheme
---------------------

Dot-separated ``subsystem.object.quantity`` names, with dimensions carried
as labels (never baked into the name):

  ``fleet.replica.queue_depth``      gauge   {tenant, replica}
  ``fleet.replica.dispatched``       counter {tenant, replica}
  ``fleet.dispatch.overhead_us``     histogram {tenant} — host-side cost of
                                     picking a replica + enqueueing
  ``fleet.request.latency_us``       histogram {tenant} — rolling
                                     percentiles (P²), not one-shot arrays
  ``fleet.batch.size``               histogram {tenant}
  ``fleet.batch.throughput_eps``     gauge   {tenant}
  ``sim.resource.utilization``       gauge   {resource, kind} — busy
                                     fraction over the run makespan
  ``sim.resource.wait_cycles``       gauge   {resource} — queueing behind
                                     co-resident tenants
  ``sim.bottleneck.utilization``     gauge   {resource} — the II-setting
                                     stage
  ``sim.event.latency_ns``           histogram {instance}
  ``sim.instance.steady_interval_ns``  gauge {instance}
  ``sim.fastpath.compile_s`` / ``sim.fastpath.replay_s``  gauge {} —
                                     compiled-replay engine cost split
                                     (:mod:`repro_torch.sim.fastpath`): one-time
                                     graph compile vs per-run replay
  ``sim.fastpath.events_per_sec``    gauge {} — replay throughput; the
                                     quantity ``benchmarks/sim_fastpath.py``
                                     gates against the DES (>= 20x on the
                                     sweep-engine scenarios)
  ``sim.fastpath.replays``           counter {engine: sweep|heap}
  ``sim.fastpath.fallbacks``         counter {reason} — auto-engine runs
                                     routed back to the full DES (trace,
                                     tracer, profile/blame, ...); a rising
                                     rate means the hot path is silently
                                     paying DES cost
  ``dse.candidates_evaluated``       counter {model}
  ``dse.pareto_survivors``           counter {model}
  ``dse.rescore_invocations``        counter {model}
  ``dse.walltime_s``                 gauge   {model, phase: dp|score|
                                     rescore|exhaustive}
  ``dse.exhaustive_candidates``      gauge   {model} — designs enumerated
                                     by ``search(exhaustive=True)``
  ``tenancy.frontier.points``        counter {model}
  ``tenancy.pack.backoffs``          counter {}
  ``calib.fit.r2`` / ``calib.fit.mape``  gauge {family: single_aie|cascade|
                                     dma|agg|overall} — calibration fit
                                     quality per sweep family (CI-gated)
  ``calib.param.value``              gauge   {param} — fitted overhead
                                     constant (compare against the frozen
                                     ``OverheadParams`` default)
  ``calib.sweep.points`` / ``calib.stage.drifted``  gauge {} — sweep size
                                     and count of drifting pipeline stages
  ``load.offered`` / ``load.admitted`` / ``load.shed``  counter {tenant} —
                                     open-loop ingress accounting at
                                     ``FleetServer.offer``: *offered* is a
                                     statement about demand, *admitted*
                                     about throughput; their gap (shed) is
                                     admission control, never silent loss
  ``fleet.request.queue_wait_us``    histogram {tenant} — submit-to-start
                                     wait (the queueing term of sojourn)
  ``sim.event.sojourn_ns`` / ``sim.event.queue_wait_ns``  histogram
                                     {instance} — open-loop DES sojourn
                                     measured from the *intended* arrival
  ``sim.instance.offered_eps``       gauge {instance} — offered arrival
                                     rate realized by the DES trace
  ``slo.requests.good`` / ``slo.requests.bad`` / ``slo.requests.shed``
                                     counter {tenant} — per-request SLO
                                     classification (bad = over the p99
                                     latency budget; shed counts as bad)
  ``slo.burn_rate``                  gauge {tenant, window} — bad fraction
                                     over the window divided by the error
                                     budget (1 - availability): 1.0 spends
                                     the budget exactly at the window's
                                     length, >1 exhausts it early
  ``slo.error_budget.remaining``     gauge {tenant} — 1 - burn over the
                                     full SLO window; <= 0 means exhausted
                                     (``launch.serve --slo`` exits 1)
  ``model.queue.sojourn_mean_ns`` / ``model.queue.sojourn_p99_ns`` —
                                     drift family (see below): analytic
                                     queueing model vs DES on one shared
                                     arrival trace, CI-gated at 10%
  ``profile.blame.cycles`` / ``profile.blame.share``  gauge {instance,
                                     category} — critical-path blame from
                                     :func:`repro_torch.obs.profile.profile_run`:
                                     cycles (and share of total) each
                                     overhead category contributes to the
                                     walked-back critical paths. Category
                                     is either one of
                                     ``perfmodel.BLAME_CATEGORIES`` or an
                                     emergent Tier-S wait —
                                     ``queue_wait`` (blocked behind this
                                     instance's own earlier work),
                                     ``admission_wait`` (open-loop gate),
                                     or ``xtenant:<tenant>#<replica>``
                                     (blocked on a shared resource held by
                                     that co-resident instance: the blame
                                     key *names the tenant at fault*)
  ``model.blame.<category>`` —       drift family (see below): Tier-A
                                     analytic blame share
                                     (``perfmodel.latency_blame``) vs the
                                     walked-back Tier-S share per
                                     category

Drift-ratio semantics
---------------------

For every (key, metric) pair the monitor stores one *modeled* reference
(:meth:`DriftMonitor.expect`) and a stream of *measurements*
(:meth:`DriftMonitor.observe`). ``ratio = measured_mean / modeled``:
1.0 is perfect agreement, 1.3 means the measurement runs 30% above the
model. Two families are reported side by side and must not be conflated:

  * ``model.*`` metrics compare Tier-A analytic predictions against
    Tier-S simulated execution of the *same placement* — both are models
    of the VEK280, so the ratio should sit at ~1.0 and its MAPE is a
    CI-gateable regression signal (the ``--drift-gate`` flag).
    ``model.queue.sojourn_{mean,p99}_ns`` extends the family to latency
    under load: the collapsed-bottleneck queueing model (exact Lindley /
    re-entrant recursion, :mod:`repro_torch.core.tenancy`) and the DES are fed
    the *same* seeded arrival trace, so the comparison cancels Monte
    Carlo noise and gates structural drift only (keys
    ``{model}@rho{util}``, ``benchmarks/latency_under_load.py``). The
    per-stage sub-family ``model.stage.{shim|comp|comm}`` (keys
    ``{design}/{stage}``, written by ``repro_torch.core.calibrate``) localizes a
    total-latency drift to the pipeline stage that moved; map the stage
    kind to its suspect overhead constants via
    ``repro_torch.core.calibrate.STAGE_SUSPECTS`` and
    :meth:`DriftMonitor.localize`. ``calib.param`` entries (expect =
    frozen constant, observe = fitted) rank the constants themselves.
    ``model.blame.<category>`` (keys = design/tenant names, written by
    :func:`repro_torch.obs.profile.feed_blame_drift`) gates the *decomposition*
    rather than the total: both sides are normalized over
    ``perfmodel.BLAME_CATEGORIES`` only — emergent Tier-S waits
    (``queue_wait``, ``admission_wait``, ``xtenant:*``) are deliberately
    excluded because the analytic model has no contention terms, so the
    gate measures attribution fidelity, not queueing. Shares are signed
    (a negative calibration constant yields a negative share) and a
    category empty on both sides is skipped, not scored as agreement.
  * ``serve.*`` metrics compare the modeled VEK280 numbers against
    *wall-clock* serving (host and card), where the ratio is expected
    to be orders of magnitude above 1 — it tracks relative drift of the
    deployment over time, not absolute agreement.
"""
from __future__ import annotations

from .drift import DriftEntry, DriftMonitor
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, P2Quantile
from .profile import (BlameSegment, EventProfile, RunProfile,
                      WhatIfProjection, add_flow_events, feed_blame_drift,
                      is_wait_category, profile_run, top_levers, whatif)
from .slo import (BurnAlert, BurnWindow, SLOReport, SLOSpec, SLOTracker,
                  parse_slo)
from .tracing import DEFAULT_PIDS, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "P2Quantile",
    "Tracer", "DEFAULT_PIDS", "DriftMonitor", "DriftEntry",
    "SLOSpec", "SLOTracker", "SLOReport", "BurnWindow", "BurnAlert",
    "parse_slo",
    "BlameSegment", "EventProfile", "RunProfile", "WhatIfProjection",
    "profile_run", "whatif", "top_levers", "feed_blame_drift",
    "add_flow_events", "is_wait_category",
]
