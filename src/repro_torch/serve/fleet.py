"""Fleet serving engine: dispatch events across R replicas.

Runtime counterpart of the Tier-A multi-tenant scheduler
(:mod:`repro_torch.core.tenancy`). Where :class:`repro_torch.serve.JetServer` is one
μ-ORCA instance (one fused kernel + one micro-batching loop), the
:class:`FleetServer` is the whole array: every tenant (model) gets R replica
servers, each with its own batching window, worker thread and, on the card,
CUDA stream — the counterpart of R disjoint rectangles on the AIE grid.
Incoming events are dispatched round-robin or least-loaded across the
tenant's replicas, multiplying throughput at constant per-event latency,
exactly the trade the spatial packer makes in tiles.

Two dispatch granularities:

  * :meth:`FleetServer.submit` — one event at a time, the trigger-stream
    case.
  * :meth:`FleetServer.infer_batch` — micro-batched dispatch: a batch is
    *sliced* across the tenant's replicas (scatter), every slice rides one
    replica's batching window as a single kernel launch, and results are
    gathered back in submission order with per-event latencies and batched
    percentiles (:class:`BatchResult`). This is the serving analogue of
    pipelined ingest: replicas stay busy back to back instead of waiting
    for a round trip per event.

The fleet reports *measured* wall-clock percentiles and events/sec (merged
across replicas, plus per-replica dispatch accounting) side by side with the
*modeled* Tier-A numbers for the same replica count on the VEK280 — since
the pipelined execution model, both the serial ``R / latency`` figures and
the contended pipelined frontier point ({latency, II, sustained events/sec}
from :func:`repro_torch.core.tenancy.throughput_frontier`), so the measured
run and the analytical hardware story stay comparable.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import aie_arch, dse, tenancy
from repro_torch.core.layerspec import ModelSpec
from repro_torch.obs import DriftMonitor, MetricsRegistry, Tracer
from repro_torch.obs.slo import SLOReport, SLOSpec, SLOTracker
from repro_torch.quant import QuantizedMLP
from repro_torch.serve import JetServer, ServeStats, _Request


@dataclasses.dataclass
class BatchResult:
    """Gathered result of one micro-batched dispatch.

    ``results`` preserves submission order regardless of which replica
    served each slice; ``stats`` holds the batch's own latencies (batched
    percentiles over exactly these events, not the server's lifetime), and
    ``replica_counts`` records the scatter (events per replica).
    """

    results: np.ndarray
    stats: ServeStats
    wall_us: float
    replica_counts: List[int]

    @property
    def n(self) -> int:
        return len(self.stats.latencies_us)

    def percentile(self, p: float) -> float:
        return self.stats.percentile(p)

    @property
    def throughput_eps(self) -> float:
        return self.n / (self.wall_us * 1e-6) if self.wall_us > 0 else 0.0

    def summary(self) -> dict:
        return {"n": self.n, "p50_us": self.percentile(50),
                "p99_us": self.percentile(99), "wall_us": self.wall_us,
                "throughput_eps": self.throughput_eps,
                "replica_counts": list(self.replica_counts)}


@dataclasses.dataclass
class TenantSpec:
    """One model deployed on the fleet with ``replicas`` independent copies.

    ``model_spec`` (the Tier-A :class:`ModelSpec`) is optional; when given,
    :meth:`FleetServer.modeled_throughput` packs the same replica count onto
    the modeled VEK280 array for the hardware-side comparison.
    """

    name: str
    qmlp: QuantizedMLP
    rho: Optional[QuantizedMLP] = None
    agg: str = "mean"
    mode: str = "fused"
    replicas: int = 1
    model_spec: Optional[ModelSpec] = None


class FleetServer:
    """Multi-replica, multi-tenant inference fleet.

    ``policy``: 'rr' (round-robin) or 'least_loaded' (shortest replica queue,
    ties broken by fewest dispatches). ``device`` defaults to CUDA, raises
    where there is none, and is every replica's :class:`JetServer` device.
    """

    def __init__(self, tenants: Sequence[TenantSpec], *,
                 policy: str = "least_loaded",
                 max_batch: int = 64,
                 window_us: float = 200.0,
                 device="cuda",
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 slos: Optional[Dict[str, SLOSpec]] = None,
                 admission_depth: Optional[int] = None):
        if policy not in ("rr", "least_loaded"):
            raise ValueError(f"unknown dispatch policy {policy!r}")
        if not tenants:
            raise ValueError("at least one tenant required")
        self.policy = policy
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.drift = DriftMonitor()
        #: offered events above this per-replica queue depth are shed by
        #: :meth:`offer` (None = admit everything, the pre-SLO behavior)
        self.admission_depth = admission_depth
        self.slo_trackers: Dict[str, SLOTracker] = {}
        for name, spec in (slos or {}).items():
            if spec.tenant != name:
                raise ValueError(f"SLO key {name!r} names tenant "
                                 f"{spec.tenant!r}")
            self.slo_trackers[name] = SLOTracker(spec,
                                                 registry=self.registry)
        self.tenants: Dict[str, TenantSpec] = {}
        self._servers: Dict[str, List[JetServer]] = {}
        self._dispatched: Dict[str, List[int]] = {}
        self._rr: Dict[str, int] = {}
        self._default = tenants[0].name
        self._design_cache: Dict[str, Optional[dse.DSEResult]] = {}
        # Per-tenant metric handles, resolved once so the dispatch hot path
        # does no registry lookups.
        self._m_overhead: Dict[str, object] = {}
        self._m_batch: Dict[str, object] = {}
        self._m_tput: Dict[str, object] = {}
        self._m_dispatched: Dict[str, List[object]] = {}
        self._m_depth: Dict[str, List[object]] = {}
        self._m_offered: Dict[str, object] = {}
        self._m_admitted: Dict[str, object] = {}
        self._m_shed: Dict[str, object] = {}
        # Validate every spec BEFORE building any JetServer: each server
        # starts a worker thread, and a mid-construction raise would leak
        # threads with no handle left to close() them.
        seen = set()
        for t in tenants:
            if t.name in seen:
                raise ValueError(f"duplicate tenant {t.name!r}")
            if t.replicas < 1:
                raise ValueError(f"tenant {t.name!r}: replicas must be >= 1")
            seen.add(t.name)
        for name in self.slo_trackers:
            if name not in seen:
                raise ValueError(f"SLO for unknown tenant {name!r}")
        for t in tenants:
            self.tenants[t.name] = t
            servers = [
                JetServer(t.qmlp, rho=t.rho, agg=t.agg, mode=t.mode,
                          max_batch=max_batch, window_us=window_us,
                          device=self.device)
                for _ in range(t.replicas)]
            self._servers[t.name] = servers
            self._dispatched[t.name] = [0] * t.replicas
            self._rr[t.name] = 0
            reg = self.registry
            self._m_overhead[t.name] = reg.histogram(
                "fleet.dispatch.overhead_us", {"tenant": t.name})
            self._m_batch[t.name] = reg.histogram(
                "fleet.batch.size", {"tenant": t.name})
            self._m_tput[t.name] = reg.gauge(
                "fleet.batch.throughput_eps", {"tenant": t.name})
            self._m_dispatched[t.name] = [
                reg.counter("fleet.replica.dispatched",
                            {"tenant": t.name, "replica": str(i)})
                for i in range(t.replicas)]
            self._m_depth[t.name] = [
                reg.gauge("fleet.replica.queue_depth",
                          {"tenant": t.name, "replica": str(i)})
                for i in range(t.replicas)]
            self._m_offered[t.name] = reg.counter("load.offered",
                                                  {"tenant": t.name})
            self._m_admitted[t.name] = reg.counter("load.admitted",
                                                   {"tenant": t.name})
            self._m_shed[t.name] = reg.counter("load.shed",
                                               {"tenant": t.name})
            for i, s in enumerate(servers):
                s.on_done = self._replica_observer(t.name, i, s)

    def _replica_observer(self, tenant: str, i: int, server: JetServer):
        """Per-replica completion hook run on the replica's worker thread.

        Streams the measured latency into the tenant's rolling histogram,
        refreshes the queue-depth gauge, and feeds the drift monitor's
        ``serve.latency_us`` stream for replica key ``tenant#i``. Distinct
        replicas write distinct drift keys, so cross-thread writes never
        touch the same entry.
        """
        lat = self.registry.histogram("fleet.request.latency_us",
                                      {"tenant": tenant})
        wait = self.registry.histogram("fleet.request.queue_wait_us",
                                       {"tenant": tenant})
        done = self.registry.counter("fleet.replica.completed",
                                     {"tenant": tenant, "replica": str(i)})
        depth = self._m_depth[tenant][i]
        key = f"{tenant}#{i}"
        slo = self.slo_trackers.get(tenant)

        def observe(req: _Request) -> None:
            lat.record(req.latency_us)
            wait.record(req.queue_wait_us)
            done.inc()
            depth.set(float(server._q.qsize()))
            self.drift.observe(key, "serve.latency_us", req.latency_us)
            if slo is not None:
                slo.record(req.latency_us * 1e3)

        return observe

    # -- dispatch -------------------------------------------------------------
    def _pick(self, tenant: str) -> int:
        servers = self._servers[tenant]
        if self.policy == "rr":
            i = self._rr[tenant]
            self._rr[tenant] = (i + 1) % len(servers)
            return i
        return min(range(len(servers)),
                   key=lambda i: (servers[i]._q.qsize(),
                                  self._dispatched[tenant][i]))

    def submit(self, x: np.ndarray, tenant: Optional[str] = None) -> _Request:
        name = tenant or self._default
        if name not in self._servers:
            raise KeyError(f"unknown tenant {name!r}")
        t0 = time.perf_counter()
        i = self._pick(name)
        self._dispatched[name][i] += 1
        self._m_dispatched[name][i].inc()
        req = self._servers[name][i].submit(x)
        self._m_depth[name][i].set(float(self._servers[name][i]._q.qsize()))
        self._m_overhead[name].record((time.perf_counter() - t0) * 1e6)
        return req

    def infer(self, x: np.ndarray, tenant: Optional[str] = None,
              timeout: float = 30.0) -> np.ndarray:
        req = self.submit(x, tenant)
        if not req.event.wait(timeout):
            raise TimeoutError("fleet inference timed out")
        if req.error is not None:
            raise RuntimeError("serving batch failed") from req.error
        return req.result

    def offer(self, x: np.ndarray,
              tenant: Optional[str] = None) -> Optional[_Request]:
        """Admission-controlled submit: the open-loop ingress of the fleet.

        Counts the event as *offered*; sheds it (returns None, counting it
        against the tenant's error budget) when every replica's queue sits
        at or above ``admission_depth``, otherwise admits it via
        :meth:`submit`. With ``admission_depth=None`` nothing is ever shed
        and offered == admitted — the offered/admitted/shed split is what
        separates the measured serving rate (a *throughput* statement)
        from the offered rate (a *load* statement) in the `load.*` family.
        """
        name = tenant or self._default
        if name not in self._servers:
            raise KeyError(f"unknown tenant {name!r}")
        self._m_offered[name].inc()
        if self.admission_depth is not None:
            depth = min(s._q.qsize() for s in self._servers[name])
            if depth >= self.admission_depth:
                self._m_shed[name].inc()
                slo = self.slo_trackers.get(name)
                if slo is not None:
                    slo.record_shed()
                return None
        self._m_admitted[name].inc()
        return self.submit(x, name)

    def slo_snapshot(self, now: Optional[float] = None) -> SLOReport:
        """Cross-tenant SLO roll-up (error budgets, burn rates, alerts)."""
        return SLOReport.from_trackers(self.slo_trackers, now=now,
                                       meta={"policy": self.policy,
                                             "admission_depth":
                                                 self.admission_depth})

    # -- micro-batched dispatch ----------------------------------------------
    def submit_batch(self, xs: Sequence[np.ndarray],
                     tenant: Optional[str] = None) -> List[_Request]:
        """Scatter a batch across the tenant's replicas.

        The batch is split into one contiguous slice per replica, sized by
        the replica's current queue depth (:meth:`_slices`); slice ``i`` is
        enqueued on replica ``i`` back to back, so each replica's collection
        window coalesces its whole slice into a single kernel launch instead
        of one launch per round trip. Returns the requests in submission
        order (use :meth:`gather`).
        """
        name = tenant or self._default
        if name not in self._servers:
            raise KeyError(f"unknown tenant {name!r}")
        if len(xs) == 0:
            return []
        reqs, _ = self._submit_batch(xs, name)
        return reqs

    def _slices(self, tenant: str, n: int) -> List[np.ndarray]:
        """Adaptive scatter: contiguous slices sized ∝ 1 / (1 + queue depth).

        A backlogged replica gets a proportionally smaller slice so every
        replica drains at roughly the same time; on idle (equal-depth)
        replicas the largest-remainder rounding reduces exactly to the
        balanced ``np.array_split`` of the original static scatter (the
        first ``n mod R`` replicas take the extra event). Deterministic:
        remainder ties favour lower replica indices.
        """
        servers = self._servers[tenant]
        weights = [1.0 / (1.0 + s._q.qsize()) for s in servers]
        total = sum(weights)
        shares = [n * w / total for w in weights]
        counts = [int(s) for s in shares]
        spare = n - sum(counts)
        for i in sorted(range(len(servers)),
                        key=lambda i: (-(shares[i] - counts[i]), i))[:spare]:
            counts[i] += 1
        out, start = [], 0
        for c in counts:
            out.append(np.arange(start, start + c))
            start += c
        return out

    def _submit_batch(self, xs: Sequence[np.ndarray],
                      name: str) -> Tuple[List[_Request], List[int]]:
        """Scatter + enqueue; returns (requests in order, events per replica)."""
        servers = self._servers[name]
        t0 = time.perf_counter()
        slices = self._slices(name, len(xs))
        reqs: List[Optional[_Request]] = [None] * len(xs)
        for i, idxs in enumerate(slices):
            for j in idxs:
                reqs[j] = servers[i].submit(xs[j])
                self._dispatched[name][i] += 1
                self._m_dispatched[name][i].inc()
            if len(idxs):
                self._m_depth[name][i].set(float(servers[i]._q.qsize()))
        self._m_overhead[name].record((time.perf_counter() - t0) * 1e6)
        return reqs, [len(ix) for ix in slices]

    def gather(self, reqs: Sequence[_Request],
               timeout: float = 30.0) -> np.ndarray:
        """Wait for every request and stack results in submission order;
        raises when a replica's batch failed."""
        if not reqs:
            return np.empty((0,))
        for i, req in enumerate(reqs):
            if not req.event.wait(timeout):
                raise TimeoutError(f"batched event {i} timed out")
            if req.error is not None:
                raise RuntimeError(f"batched event {i} failed") from req.error
        return np.stack([req.result for req in reqs])

    def infer_batch(self, xs: Sequence[np.ndarray],
                    tenant: Optional[str] = None,
                    timeout: float = 30.0) -> BatchResult:
        """Micro-batched scatter/gather dispatch with batched percentiles."""
        name = tenant or self._default
        if name not in self._servers:
            raise KeyError(f"unknown tenant {name!r}")
        if len(xs) == 0:
            return BatchResult(results=np.empty((0,)), stats=ServeStats(),
                               wall_us=0.0,
                               replica_counts=[0] * len(self._servers[name]))
        t0 = time.perf_counter()
        reqs, counts = self._submit_batch(xs, name)
        results = self.gather(reqs, timeout=timeout)
        t1 = time.perf_counter()
        wall_us = (t1 - t0) * 1e6
        stats = ServeStats()
        for req in reqs:
            stats.record(req.t_submit, req.t_done)
        self._m_batch[name].record(float(len(xs)))
        if wall_us > 0:
            self._m_tput[name].set(len(xs) / (wall_us * 1e-6))
        if self.tracer is not None:
            self.tracer.span_us(
                "fleet", f"{name}.dispatch", f"infer_batch[{len(xs)}]",
                self.tracer.wall_us(t0), wall_us, cat="fleet",
                args={"replica_counts": counts})
            start = 0
            for i, c in enumerate(counts):
                sl = reqs[start:start + c]
                start += c
                if not sl:
                    continue
                ts = min(r.t_submit for r in sl)
                te = max(r.t_done for r in sl)
                self.tracer.span_us(
                    "fleet", f"{name}#{i}", f"slice[{c}]",
                    self.tracer.wall_us(ts),
                    max((te - ts) * 1e6, 0.0), cat="slice",
                    args={"events": c})
        return BatchResult(results=results, stats=stats, wall_us=wall_us,
                           replica_counts=counts)

    def close(self) -> None:
        for servers in self._servers.values():
            for s in servers:
                s.close()

    # -- measured stats -------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return sum(len(s) for s in self._servers.values())

    def replica_counts(self, tenant: Optional[str] = None) -> List[int]:
        """Events dispatched per replica; Σ counts == events submitted.

        With ``tenant`` the list covers that tenant's replicas; with None it
        covers every replica in the fleet (tenant declaration order), so the
        total always matches ``stats(tenant).summary()['n']`` for the same
        argument."""
        if tenant is not None:
            return list(self._dispatched[tenant])
        return [c for name in self._servers for c in self._dispatched[name]]

    def stats(self, tenant: Optional[str] = None) -> ServeStats:
        """Merged ServeStats across a tenant's replicas (or the whole fleet
        when ``tenant`` is None and there is more than one tenant)."""
        names = [tenant] if tenant else list(self._servers)
        replicas = [s for name in names for s in self._servers[name]]
        merged = ServeStats()
        for s in replicas:
            merged.latencies_us.extend(s.stats.latencies_us)
            merged.batch_sizes.extend(s.stats.batch_sizes)
        firsts = [s.stats.t_first_submit for s in replicas
                  if s.stats.t_first_submit is not None]
        lasts = [s.stats.t_last_done for s in replicas
                 if s.stats.t_last_done is not None]
        merged.t_first_submit = min(firsts) if firsts else None
        merged.t_last_done = max(lasts) if lasts else None
        return merged

    def summary(self) -> dict:
        per_tenant = {}
        for name, servers in self._servers.items():
            s = self.stats(name).summary()
            s["replicas"] = len(servers)
            s["dispatched"] = list(self._dispatched[name])
            # Rolling percentiles from the streaming histogram (P² + buckets)
            # — O(1) memory, unlike the exact ServeStats percentiles above
            # which keep every latency.
            h = self.registry.find("fleet.request.latency_us",
                                   {"tenant": name})
            if h is not None and h.count:
                s["rolling_p50_us"] = h.quantile(0.50)
                s["rolling_p90_us"] = h.quantile(0.90)
                s["rolling_p99_us"] = h.quantile(0.99)
            per_tenant[name] = s
        fleet = self.stats().summary()
        fleet["replicas"] = self.num_replicas
        return {"fleet": fleet, "tenants": per_tenant}

    # -- Tier-A modeled throughput on the VEK280 ------------------------------
    def modeled_throughput(self, *, contention: str = "analytic",
                           frontier: bool = True) -> dict:
        """Pack each tenant's deployed replica count onto the modeled array.

        Schedules the fleet's tenant mix with :func:`repro_torch.core.tenancy.
        pack_mix` (which starts at every tenant's latency-optimal §5.2 design
        and backs off along the {tiles, latency} frontier until the mix
        fits), then reports per-tenant modeled {latency_ns, interval_ns,
        serial events_per_sec, pipelined events_per_sec free + shim-
        contended}. With ``frontier`` (default) each tenant also carries
        ``frontier_point``: the contended *pipelined* throughput-frontier
        point (:func:`repro_torch.core.tenancy.throughput_frontier`, priced by
        ``contention`` — "analytic" or "sim") at the deployed replica
        count, or the nearest frontier point below it — the hardware-side
        target the measured percentiles should sit next to. ``feasible`` is
        False only when even the smallest designs do not fit the 304-tile
        grid / shared PLIO budget at the deployed replica counts. Tenants
        without a ``model_spec`` are skipped.
        """
        mix = [(name, t.model_spec, t.replicas)
               for name, t in self.tenants.items() if t.model_spec is not None]
        if not mix:
            return {}
        out: Dict[str, dict] = {}
        sched = tenancy.pack_mix(mix, registry=self.registry)
        if sched is None:
            for name, spec, r in mix:
                best = self._design(name)
                lat_ns = best.latency.total_ns if best else float("nan")
                ii_ns = (best.interval_ns or lat_ns) if best else float("nan")
                out[name] = {"replicas": r, "latency_ns": lat_ns,
                             "interval_ns": ii_ns,
                             "events_per_sec": (r * 1e9 / lat_ns) if best else 0.0,
                             "events_per_sec_pipelined":
                                 (r * 1e9 / ii_ns) if best else 0.0,
                             "feasible": False}
            return out
        scp = sched.shim_contention(pipelined=True)
        per_tenant: Dict[str, dict] = {}
        for inst, factor in zip(sched.instances, scp.factors):
            t = per_tenant.setdefault(inst.tenant, {
                "replicas": 0, "latency_ns": 0.0, "interval_ns": 0.0,
                "events_per_sec": 0.0, "events_per_sec_pipelined": 0.0,
                "events_per_sec_pipelined_contended": 0.0, "tiles": 0,
                "feasible": True})
            t["replicas"] += 1
            t["latency_ns"] = max(t["latency_ns"], inst.latency_ns)
            t["interval_ns"] = max(t["interval_ns"], inst.interval_ns)
            t["events_per_sec"] += 1e9 / inst.latency_ns
            t["events_per_sec_pipelined"] += 1e9 / inst.interval_ns
            t["events_per_sec_pipelined_contended"] += (factor * 1e9
                                                        / inst.interval_ns)
            t["tiles"] += inst.tiles
        out.update(per_tenant)
        if frontier:
            for name, spec, r in mix:
                fr = tenancy.throughput_frontier(spec, contention=contention,
                                                 registry=self.registry)
                at_or_below = [pt for pt in fr if pt.replicas <= r]
                pick = (max(at_or_below, key=lambda pt: pt.replicas)
                        if at_or_below else (fr[0] if fr else None))
                if pick is not None:
                    out[name]["frontier_point"] = pick.as_dict()
        out["_fleet"] = sched.summary()
        return out

    # -- drift monitoring ------------------------------------------------------
    def _design(self, name: str) -> Optional[dse.DSEResult]:
        """Latency-optimal §5.2 design for a tenant, cached per fleet."""
        if name not in self._design_cache:
            spec = self.tenants[name].model_spec
            self._design_cache[name] = (
                dse.explore(spec, registry=self.registry)
                if spec is not None else None)
        return self._design_cache[name]

    def drift_snapshot(self, *, tier_s: bool = True) -> DriftMonitor:
        """Refresh the drift monitor's modeled references and return it.

        Two families (see the :mod:`repro_torch.obs` docstring):

          * ``serve.latency_us`` / ``serve.interval_us`` per replica key
            ``tenant#i`` — measured wall-clock serving against the Tier-A
            modeled VEK280 numbers. Wall-clock serving sits orders
            of magnitude above the modeled hardware, so these ratios track
            *relative* drift across replicas and over time, never absolute
            accuracy.
          * ``model.latency_ns`` / ``model.interval_ns`` per tenant — Tier-A
            analytic prediction vs the Tier-S discrete-event simulator for
            the same design. Both sides are modeled, agreement is expected
            within a few percent, and this is the path a CI drift gate can
            hold to a MAPE threshold.

        ``serve.latency_us`` measurements stream in continuously via the
        per-replica completion hooks; this call fills in the modeled side
        (and, with ``tier_s``, runs the simulator once per tenant).
        """
        mon = self.drift
        for name, t in self.tenants.items():
            best = self._design(name)
            if best is None:
                continue
            lat_us = best.latency.total_ns / 1000.0
            ii_ns = best.interval_ns or best.latency.total_ns
            for i, s in enumerate(self._servers[name]):
                key = f"{name}#{i}"
                mon.expect(key, "serve.latency_us", lat_us)
                st = s.stats
                if (st.t_first_submit is not None
                        and len(st.latencies_us) >= 2):
                    span_s = st.t_last_done - st.t_first_submit
                    mon.expect(key, "serve.interval_us", ii_ns / 1000.0)
                    mon.observe(key, "serve.interval_us",
                                span_s * 1e6 / len(st.latencies_us))
            if tier_s:
                from repro_torch.sim.run import SimConfig, simulate_placement
                mon.expect(name, "model.latency_ns", best.latency.total_ns)
                one = simulate_placement(
                    best.placement, tenant=name,
                    config=SimConfig(events=1, trace=False))
                mon.observe(name, "model.latency_ns",
                            aie_arch.ns(one.latency_cycles))
                mon.expect(name, "model.interval_ns", ii_ns)
                piped = simulate_placement(
                    best.placement, tenant=name,
                    config=SimConfig(events=10, pipeline_depth=4,
                                     trace=False))
                mon.observe(name, "model.interval_ns", aie_arch.ns(
                    piped.instances[0].steady_interval_cycles()))
        return mon

    def profile_snapshot(self, *, events: int = 1,
                         levers: bool = True) -> dict:
        """Per-tenant critical-path blame profile of the deployed designs.

        Runs the Tier-S simulator once per tenant on its cached §5.2
        design, walks back each event's critical path
        (:func:`repro_torch.obs.profile.profile_run`), and compares the Tier-S
        blame shares against the Tier-A analytic decomposition
        (:func:`repro_torch.core.perfmodel.latency_blame`) through this fleet's
        drift monitor under the ``model.blame.*`` metric family — so one
        call both answers "where do the cycles go?" and refreshes the
        blame side of the drift gate.

        Returns ``{tenant: {"blame_cycles", "blame_shares", "dominant",
        "blame_mape", "top_lever"}}`` where ``top_lever`` (with
        ``levers=True``) is the best single what-if — the overhead
        category whose halving projects the largest causal speedup.
        """
        from repro_torch.core.perfmodel import latency_blame
        from repro_torch.obs import profile as obsprofile
        from repro_torch.sim.run import SimConfig, simulate_placement

        out: Dict[str, dict] = {}
        for name, t in self.tenants.items():
            best = self._design(name)
            if best is None:
                continue
            res = simulate_placement(
                best.placement, tenant=name,
                config=SimConfig(events=events, trace=False))
            prof = obsprofile.profile_run(res)
            obsprofile.feed_blame_drift(
                self.drift, name, latency_blame(best.placement),
                prof.blame_cycles())
            cycles = prof.blame_cycles()
            shares = prof.blame_shares()
            dominant = (max(shares.items(), key=lambda kv: abs(kv[1]))
                        if shares else None)
            apes = [e.ape for e in self.drift.entries()
                    if e.key == name and e.metric.startswith("model.blame.")
                    and e.ape is not None]
            entry: Dict[str, object] = {
                "blame_cycles": cycles,
                "blame_shares": shares,
                "dominant": dominant,
                "blame_mape": sum(apes) / len(apes) if apes else None,
            }
            if levers:
                top = obsprofile.top_levers(res)
                entry["top_lever"] = top[0].as_dict() if top else None
            out[name] = entry
        return out

    def telemetry_snapshot(self, *, drift: bool = True,
                           tier_s: bool = True) -> dict:
        """One JSON-ready bundle: metrics snapshot + serving summary + drift."""
        snap: Dict[str, object] = {}
        if drift:
            # Before the metrics snapshot: the drift pass may run the DSE and
            # simulator, whose own counters belong in the same snapshot.
            snap["drift"] = self.drift_snapshot(tier_s=tier_s).summary()
        snap["metrics"] = self.registry.snapshot()
        snap["serve"] = self.summary()
        if self.slo_trackers:
            snap["slo"] = self.slo_snapshot().as_dict()
        return snap
