"""μs-scale jet-tagging serving driver — the paper's deployment scenario.

Trains a small MLP or DeepSets tagger on the synthetic jet stream (float32,
plain SGD), quantizes it to the paper's INT8 power-of-two scheme, deploys it
behind the batching ``JetServer`` running the fused cascade kernel on the
GPU, and reports:

  * classification accuracy float vs INT8 (quantization cost),
  * per-event latency percentiles with events sent one at a time,
  * events per second for the same events sent at once (a burst that the
    server batches, up to 64 events a launch), whose outputs must equal the
    one-at-a-time outputs bit for bit,
  * the modeled H100 device time of the chain (``core.h100_model``), fused
    vs per-layer,
  * the Tier-A μ-ORCA DSE latency for the same network on the AMD VEK280
    (the paper's own deployment target; a model of that chip, not a time
    on this device), with its mapping summary.

Multi-tenant serving: with ``--replicas N`` the model is deployed behind a
``FleetServer`` with N replicas, each on its own CUDA stream; ``--mix a,b``
deploys several models side by side, the counterpart of packing tenant
rectangles onto the shared AIE array. Events are dispatched micro-batched:
sliced across replicas, scattered, gathered back with batched percentiles.
The driver then also reports the Tier-A modeled multi-tenant schedule on the
VEK280 (replica packing, shared PLIO budget) with both the serial
R/latency events/sec and the pipelined headline — initiation interval II,
sustained events/sec, and the contended pipelined throughput-frontier point.

Open-loop load and SLOs: ``--arrivals`` replaces the back-to-back batched
dispatch with a seeded wall-clock arrival process offered through the
fleet's admission control (offered vs admitted vs shed counters, queue-wait
histograms); ``--slo`` attaches per-tenant SLOs — p99 latency budget in us
plus an availability target — with windowed error-budget accounting and
multi-window burn-rate alerts. The driver exits 1 when any tenant's error
budget is exhausted, and ``--slo-report-out`` persists the cross-tenant
``SLOReport`` JSON.

    PYTHONPATH=src python -m repro_torch.launch.serve --model deepsets-32
    PYTHONPATH=src python -m repro_torch.launch.serve --model jsc-m --mode unfused
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --events 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mix deepsets-32,jsc-m --replicas 4
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \\
        --arrivals poisson:200 --slo 50000:0.95 --slo-report-out slo.json

``main`` returns the run's numbers, the quantized models and the served
outputs, so that a caller can hold them against the plain versions.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dse, layerspec
from repro_torch.data import JetConfig, jet_batch
from repro_torch.models import deepsets as ds
from repro_torch.models import mlp as mlp_lib
from repro_torch.kernels import launches
from repro_torch.obs.slo import parse_slo
from repro_torch.serve import JetServer, workload
from repro_torch.serve.fleet import FleetServer, TenantSpec

MODELS = {
    "jsc-m": dict(kind="mlp", M=64, F=16, nodes=[64, 32, 32, 32, 5]),
    "jsc-xl": dict(kind="mlp", M=64, F=16, nodes=[128, 64, 64, 64, 5]),
    "deepsets-32": dict(kind="deepsets", M=32, F=21,
                        phi=[32, 32, 32], rho=[32, 10]),
    "deepsets-64": dict(kind="deepsets", M=64, F=21,
                        phi=[64, 64, 64], rho=[64, 10]),
}
SPECS = {"jsc-m": layerspec.jsc_m, "jsc-xl": layerspec.jsc_xl,
         "deepsets-32": layerspec.deepsets_32,
         "deepsets-64": layerspec.deepsets_64}
LR = 2e-2


def _train(m: dict, n_classes: int, *, steps: int, seed: int,
           device: torch.device):
    jc = JetConfig(n_particles=m["M"], n_features=m["F"], n_classes=n_classes,
                   seed=seed)
    g = torch.Generator().manual_seed(seed)
    if m["kind"] == "mlp":
        model = mlp_lib.mlp_init(m["F"], m["nodes"], generator=g, device=device)
        loss_fn = mlp_lib.mlp_loss
    else:
        model = ds.deepsets_init(m["F"], m["phi"], m["rho"], generator=g,
                                 device=device)
        loss_fn = ds.deepsets_loss
    params = list(model.parameters())
    for step in range(steps):
        x, y = jet_batch(jc, 256, step + 1)
        loss = loss_fn(model, torch.from_numpy(x).to(device),
                       torch.from_numpy(y).to(device))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, gr in zip(params, grads):
                p.sub_(LR * gr)
        if (step + 1) % 100 == 0:
            print(f"[serve] train step {step + 1}: loss {loss.item():.4f}")
    return model, jc


def _predict(scores: np.ndarray, n_classes: int) -> int:
    """Class of one served event from the row-mean of its int8 scores (one
    row for DeepSets, M rows for an MLP), as the float path does."""
    s = scores.reshape(-1, scores.shape[-1])[:, :n_classes]
    return int(np.argmax(s.astype(np.float64).mean(axis=0)))


def _prepare(name: str, *, train_steps: int, seed: int, device: torch.device
             ) -> dict:
    """Train + quantize one model; return it with its eval context."""
    m = MODELS[name]
    n_classes = m["nodes"][-1] if m["kind"] == "mlp" else m["rho"][-1]
    model, jc = _train(m, n_classes, steps=train_steps, seed=seed,
                       device=device)
    xcal, _ = jet_batch(jc, 512, 12345)
    if m["kind"] == "mlp":
        qmlp, rho = mlp_lib.to_quantized(model, xcal), None
        float_fn = lambda x: model(x).mean(dim=1)
    else:
        qmlp, rho = ds.to_quantized(model, xcal)
        float_fn = model
    x, y = jet_batch(jc, 2048, 777)
    with torch.no_grad():
        logits = float_fn(torch.from_numpy(x).to(device))
    acc_float = float((logits.argmax(-1).cpu().numpy() == y).mean())
    return dict(name=name, qmlp=qmlp, rho=rho, jc=jc, n_classes=n_classes,
                acc_float=acc_float)


def _events(prep: dict, n: int):
    """The served stream: ``n`` events quantized to the model's input scale,
    and their labels."""
    x, y = jet_batch(prep["jc"], n, 999)
    e_in = prep["qmlp"].e_in
    return np.clip(np.round(x / 2.0 ** e_in), -128, 127).astype(np.int8), y


def _where(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _wait(reqs):
    """Waits for every request; raises on a timeout or a failed batch."""
    for r in reqs:
        if not r.event.wait(120):
            raise TimeoutError("inference timed out")
        if r.error is not None:
            raise RuntimeError("serving batch failed") from r.error
    return reqs


@contextlib.contextmanager
def _serving_window(device: torch.device):
    """Keeps the garbage collector's full collections out of a serving
    window, and counts what the window still does that would stall it.

    A full collection walks every object the process tracks (torch, the
    models, whatever the caller holds) with the GIL held, so one that starts
    inside a burst stops every worker and adds its whole pause to every event
    in flight. The heap is collected once before serving and then frozen:
    the young generations still collect what serving makes, and a full
    collection finds nothing old to walk. It is unfrozen afterwards (an
    earlier freeze with it, the interpreter's own included), so that a
    caller that runs `main` again can collect what this run left.

    Yields a dict with the pre-serving collection's time (``collect_ms``);
    once the window closes it also holds the full collections that ran
    inside it (``full_collections``) and, on CUDA, the device allocations
    the caching allocator made inside it (``cuda_mallocs``), each a
    cudaMalloc in some request's latency (``JetServer`` primes its stream
    so that a served batch needs none)."""
    stats = {"full_collections": 0}
    cuda = device.type == "cuda"

    def count(phase, info):
        if phase == "start" and info["generation"] == 2:
            stats["full_collections"] += 1

    def mallocs() -> int:
        return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)

    t0 = time.perf_counter()
    gc.collect()
    stats["collect_ms"] = (time.perf_counter() - t0) * 1e3
    m0 = mallocs() if cuda else 0
    gc.freeze()
    gc.callbacks.append(count)
    try:
        yield stats
    finally:
        gc.callbacks.remove(count)
        gc.unfreeze()
        stats["cuda_mallocs"] = mallocs() - m0 if cuda else None


def _serve_single(prep: dict, args, device: torch.device) -> dict:
    """Single-instance deployment (one JetServer)."""
    server = JetServer(prep["qmlp"], rho=prep["rho"], agg="mean",
                       mode=args.mode, device=device)
    try:
        with _serving_window(device) as window:
            xq, y = _events(prep, args.events)
            t0 = time.perf_counter()
            singles = [_wait([server.submit(xq[i])])[0]
                       for i in range(args.events)]
            wall = time.perf_counter() - t0
            p50, p99 = server.stats.percentile(50), server.stats.percentile(99)
            n_batches = len(server.stats.batch_sizes)

            t1 = time.perf_counter()
            burst = _wait([server.submit(xq[i]) for i in range(args.events)])
            burst_wall = time.perf_counter() - t1
            burst_batches = server.stats.batch_sizes[n_batches:]
        mdl = server.modeled_latency_us()
    finally:
        server.close()
    tier_a = dse.explore(SPECS[prep["name"]]())
    outputs = np.stack([r.result for r in singles])
    if not np.array_equal(outputs, np.stack([r.result for r in burst])):
        raise AssertionError("batched outputs differ from one-at-a-time ones")
    # Where one event's latency goes: the wait for its batch to start, split
    # into the worker's wake-up (submit to dequeue) and the rest of the
    # collection window (dequeue to start), and the batch's service
    # (host-to-device copy, launch, device-to-host copy).
    def p50_us(a, b):
        return float(np.median([(getattr(r, b) - getattr(r, a)) * 1e6
                                for r in singles]))
    wait_p50 = p50_us("t_submit", "t_start")
    dequeue_p50 = p50_us("t_submit", "t_dequeued")
    window_p50 = p50_us("t_dequeued", "t_start")
    service_p50 = p50_us("t_start", "t_done")
    acc_q = float(np.mean([_predict(o, prep["n_classes"]) == y[i]
                           for i, o in enumerate(outputs)]))
    where = _where(device)
    report = dict(model=prep["name"], mode=args.mode, device=where,
                  acc_float=prep["acc_float"], acc_int8=acc_q,
                  p50_us=p50, p99_us=p99, queue_wait_p50_us=wait_p50,
                  dequeue_p50_us=dequeue_p50, window_p50_us=window_p50,
                  service_p50_us=service_p50, events_per_s=args.events / wall,
                  burst_events_per_s=args.events / burst_wall,
                  burst_batches=len(burst_batches),
                  burst_max_batch=max(burst_batches),
                  modeled_fused_us=mdl["fused_us"],
                  modeled_unfused_us=mdl["unfused_us"],
                  modeled_speedup=mdl["speedup"],
                  dse_latency_ns=tier_a.latency_ns,
                  dse_summary=tier_a.summary(),
                  qmlp=prep["qmlp"], rho=prep["rho"], xq=xq, outputs=outputs,
                  serving_window=window)
    print(f"\n[serve] {prep['name']}: float acc {prep['acc_float']:.3f}, "
          f"INT8 acc {acc_q:.3f}")
    print(f"[serve] measured on {where}, mode {args.mode}, one event at a "
          f"time: p50 {p50:.1f} us, p99 {p99:.1f} us, "
          f"{report['events_per_s']:.0f} events/s (p50 wait for a batch "
          f"{wait_p50:.1f} us = dequeue {dequeue_p50:.1f} us + window "
          f"{window_p50:.1f} us; p50 batch service {service_p50:.1f} us)")
    print(f"[serve] burst of {args.events} events: "
          f"{report['burst_events_per_s']:.0f} events/s in "
          f"{len(burst_batches)} batches (largest {max(burst_batches)})")
    print(f"[serve] modeled H100 latency: fused {mdl['fused_us']:.2f} us"
          f" vs per-layer {mdl['unfused_us']:.2f} us"
          f" ({mdl['speedup']:.2f}x from fusion)")
    print(f"[serve] Tier-A μ-ORCA DSE on VEK280: {tier_a.latency_ns:.0f} ns "
          f"({tier_a.latency_ns / 1e3:.2f} us) — {tier_a.summary()}")
    return report


def _report_telemetry(fleet: FleetServer, snap: dict, args) -> None:
    """Persist the metrics snapshot and print the end-of-run summary."""
    drift = snap.get("drift", {})
    if args.metrics_out:
        fleet.registry.save(args.metrics_out,
                            extra={"drift": drift, "serve": snap["serve"]})
        print(f"[fleet] metrics: {len(fleet.registry.all())} series -> "
              f"{args.metrics_out}")
    for name, s in snap["serve"]["tenants"].items():
        if "rolling_p50_us" in s:
            print(f"[fleet] {name} rolling latency: "
                  f"p50 {s['rolling_p50_us']:.0f} us, "
                  f"p90 {s['rolling_p90_us']:.0f} us, "
                  f"p99 {s['rolling_p99_us']:.0f} us (streaming histogram)")
    overheads = fleet.registry.all("fleet.dispatch.overhead_us")
    if overheads:
        worst = max(h.quantile(0.99) for h in overheads if h.count)
        print(f"[fleet] dispatch overhead p99: {worst:.1f} us "
              f"({sum(h.count for h in overheads)} dispatches)")
    for metric in sorted(drift):
        d = drift[metric]
        mape = d.get("mape")
        if mape is None:
            continue
        tag = ("gateable Tier-A-vs-Tier-S" if metric.startswith("model.")
               else "informational wall-clock-vs-modeled")
        print(f"[fleet] drift {metric}: MAPE {100 * mape:.2f}% over "
              f"{len(d['entries'])} entr(ies) [{tag}]")


def _check_drift_gate(snap: dict, gate: float) -> None:
    """Exit nonzero when the model-path (Tier-A vs Tier-S) MAPE exceeds the
    gate. serve.* drift is never gated: the served wall clock sits orders of
    magnitude above the modeled VEK280 by construction."""
    drift = {m: d for m, d in snap.get("drift", {}).items()
             if m.startswith("model.") and d.get("mape") is not None}
    if not drift:
        raise SystemExit("[fleet] drift gate: no model.* drift entries "
                         "populated (missing model_spec?)")
    worst = max(d["mape"] for d in drift.values())
    ok = worst <= gate
    print(f"[fleet] drift gate: worst model-path MAPE {100 * worst:.2f}% "
          f"vs threshold {100 * gate:.2f}% -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        # Localize before failing: name the drifted entries and, for
        # model.stage.* metrics, the overhead constants they implicate.
        for m, d in sorted(drift.items(), key=lambda kv: -kv[1]["mape"]):
            if d["mape"] <= gate:
                continue
            flagged = d.get("flagged") or list(d.get("entries", {}))
            line = (f"[fleet] drift gate: {m} MAPE {100 * d['mape']:.2f}% "
                    f"— flagged {flagged}")
            if d.get("suspects"):
                line += f", suspect constants {d['suspects']}"
            print(line)
        raise SystemExit(1)


def _drive_open_loop(fleet: FleetServer, name: str, prep: dict, xq, y,
                     args) -> dict:
    """Offer the tenant's event stream on the --arrivals schedule."""
    spec = args.arrival_spec
    dr = workload.drive(fleet, list(xq), spec, tenant=name, seed=args.seed)
    _wait(dr.requests)
    print(f"[fleet] {name}: {spec.describe()} -> offered {dr.offered} "
          f"({dr.offered_eps:.0f}/s), admitted {dr.admitted}, "
          f"shed {dr.shed}, driver lag {dr.lag_s * 1e3:.1f} ms")
    out = dict(dr.summary(), admitted_idx=list(dr.admitted_idx),
               outputs=(np.stack([r.result for r in dr.requests])
                        if dr.requests else None))
    if dr.requests:
        adm = np.asarray(dr.admitted_idx)
        preds = np.array([_predict(r.result, prep["n_classes"])
                          for r in dr.requests])
        lats = np.array([r.latency_us for r in dr.requests])
        waits = np.array([r.queue_wait_us for r in dr.requests])
        out.update(acc_int8=float((preds == y[adm]).mean()),
                   p50_us=float(np.percentile(lats, 50)),
                   p99_us=float(np.percentile(lats, 99)),
                   queue_wait_p50_us=float(np.percentile(waits, 50)),
                   queue_wait_p99_us=float(np.percentile(waits, 99)))
        print(f"[fleet] {name}: float acc {prep['acc_float']:.3f}, "
              f"INT8 acc {out['acc_int8']:.3f} (admitted events)")
        print(f"[fleet] {name}: open-loop p50 {out['p50_us']:.0f} us, p99 "
              f"{out['p99_us']:.0f} us; queue wait p50 "
              f"{out['queue_wait_p50_us']:.0f} us, p99 "
              f"{out['queue_wait_p99_us']:.0f} us")
    return out


def _report_slo(fleet: FleetServer, args):
    """Print each tenant's budget state; persist and return the SLOReport."""
    report = fleet.slo_snapshot()
    for name, s in report.tenants.items():
        spec = s["spec"]
        state = "EXHAUSTED" if s["exhausted"] else "ok"
        print(f"[slo] {name}: p99 budget {spec['p99_latency_budget_ns'] / 1e3:.0f} us"
              f" @ {spec['availability']:.3g} availability | "
              f"good {s['good']}, bad {s['bad']}, shed {s['shed']} | "
              f"burn rate {s['burn_rate_window']:.2f}x, budget remaining "
              f"{100 * s['error_budget_remaining']:.1f}% [{state}]")
        for a in s["alerts"]:
            print(f"[slo] {name}: ALERT {a['severity']} — burn "
                  f"{a['burn_long']:.1f}x/{a['burn_short']:.1f}x over "
                  f"{a['long_s']:g}s/{a['short_s']:g}s windows "
                  f"(threshold {a['threshold']:g}x)")
    if args.slo_report_out:
        report.save(args.slo_report_out)
        print(f"[slo] report -> {args.slo_report_out}")
    return report


def _print_modeled(modeled: dict) -> None:
    """The Tier-A modeled schedule of the fleet on the VEK280."""
    for name, m in modeled.items():
        if name == "_fleet":
            print(f"[fleet] Tier-A schedule on VEK280: {m['instances']} "
                  f"instances, {m['tiles']} tiles "
                  f"({100 * m['utilization']:.0f}% of array), "
                  f"{m['plio_ports']} PLIO ports, "
                  f"{m['modeled_eps'] / 1e6:.2f} Meps serial / "
                  f"{m['modeled_eps_pipelined_contended'] / 1e6:.2f} Meps "
                  f"pipelined contended")
            continue
        print(f"[fleet] Tier-A {name}: {m['replicas']} replicas @ "
              f"{m['latency_ns']:.0f} ns -> "
              f"{m['events_per_sec'] / 1e6:.2f} Meps serial "
              f"(feasible={m['feasible']})")
        if "interval_ns" in m:
            print(f"[fleet] Tier-A {name} pipelined: II "
                  f"{m['interval_ns']:.0f} ns -> "
                  f"{m['events_per_sec_pipelined'] / 1e6:.2f} Meps free, "
                  f"{m.get('events_per_sec_pipelined_contended', 0.0) / 1e6:.2f}"
                  f" Meps shim-contended")
        fp = m.get("frontier_point")
        if fp:
            print(f"[fleet] Tier-A {name} frontier target: "
                  f"{fp['replicas']} replicas @ {fp['latency_ns']:.0f} ns"
                  f" / II {fp['interval_ns']:.0f} ns -> "
                  f"{fp['events_per_sec_pipelined_contended'] / 1e6:.2f} "
                  f"Meps sustained ({fp['contention']} contention)")


def _serve_tenant(fleet: FleetServer, name: str, prep: dict, args,
                  where: str) -> dict:
    """One tenant's stream through the fleet: open loop on the --arrivals
    schedule, or else micro-batched (``infer_batch``)."""
    xq, y = _events(prep, args.events)
    run = dict(qmlp=prep["qmlp"], rho=prep["rho"], xq=xq,
               acc_float=prep["acc_float"])
    if args.arrival_spec is not None and args.arrival_spec.open_loop:
        # Open-loop: events are *offered* on the arrival schedule and the
        # fleet's admission control decides admitted vs shed.
        run["open_loop"] = _drive_open_loop(fleet, name, prep, xq, y, args)
        run["outputs"] = run["open_loop"].pop("outputs")
        return run
    # Micro-batched dispatch: the event stream is sliced across the tenant's
    # replicas (scatter), each slice rides one replica's batching window as
    # a single kernel launch, results gather back in submission order.
    br = fleet.infer_batch(xq, tenant=name, timeout=120)
    acc_q = float(np.mean([_predict(o, prep["n_classes"]) == y[i]
                           for i, o in enumerate(br.results)]))
    run.update(outputs=br.results, batch=br.summary(), acc_int8=acc_q)
    print(f"[fleet] {name}: float acc {prep['acc_float']:.3f}, "
          f"INT8 acc {acc_q:.3f}")
    print(f"[fleet] {name}: batched p50 {br.percentile(50):.0f} us, "
          f"p99 {br.percentile(99):.0f} us, "
          f"{br.throughput_eps:.0f} events/s over "
          f"{len(br.replica_counts)} replicas on {where} "
          f"(scatter {br.replica_counts}, total {br.n})")
    return run


def _serve_fleet(preps: dict, args, device: torch.device) -> dict:
    """Multi-tenant deployment: FleetServer over R replicas per tenant."""
    tracer = None
    if args.trace_out:
        # A ChromeTrace carries both clocks: fleet spans are wall-clock
        # (span_us), simulator spans are AIE cycles (span) — one timeline.
        from repro_torch.sim.trace import ChromeTrace
        tracer = ChromeTrace(meta={"driver": "serve",
                                   "mix": ",".join(preps),
                                   "policy": args.policy})
    tenants = [TenantSpec(name=name, qmlp=p["qmlp"], rho=p["rho"], agg="mean",
                          mode=args.mode, replicas=args.replicas,
                          model_spec=SPECS[name]())
               for name, p in preps.items()]
    fleet = FleetServer(tenants, policy=args.policy, device=device,
                        tracer=tracer, slos=args.slo_specs,
                        admission_depth=args.admission_depth)
    where = _where(device)
    print(f"\n[fleet] {fleet.num_replicas} replicas across "
          f"{len(preps)} tenant(s), policy={args.policy}, on {where}")
    try:
        with _serving_window(device) as window:
            served = {name: _serve_tenant(fleet, name, prep, args, where)
                      for name, prep in preps.items()}
        modeled = fleet.modeled_throughput()
        telemetry = (fleet.telemetry_snapshot()
                     if (args.metrics_out or args.trace_out
                         or args.drift_gate is not None) else None)
        if tracer is not None:
            # Append a short Tier-S run per tenant so simulator task spans
            # land in the same trace as the fleet's dispatch/slice spans.
            from repro_torch.sim import run as simrun
            for name in preps:
                design = fleet._design(name)
                if design is not None:
                    simrun.simulate_placement(
                        design.placement, tenant=name,
                        config=simrun.SimConfig(events=2), tracer=tracer)
            tracer.save(args.trace_out)
            print(f"[fleet] unified trace: {len(tracer.spans())} spans "
                  f"-> {args.trace_out}")
    finally:
        fleet.close()
    for name, run in served.items():
        servers = fleet._servers[name]
        run.update(
            dispatched=fleet.replica_counts(name),
            batches=[len(s.stats.batch_sizes) for s in servers],
            streams=[None if s.stream is None else s.stream.cuda_stream
                     for s in servers],
            launch_streams=[sorted(s.launch_streams) for s in servers])
    if telemetry is not None:
        _report_telemetry(fleet, telemetry, args)
    _print_modeled(modeled)
    if args.drift_gate is not None and telemetry is not None:
        _check_drift_gate(telemetry, args.drift_gate)
    slo = None
    if fleet.slo_trackers:
        report = _report_slo(fleet, args)
        if not report.ok:
            print(f"[slo] error budget exhausted for "
                  f"{report.exhausted_tenants} -> exit 1")
            raise SystemExit(report.exit_code())
        slo = report.as_dict()
    return dict(mode=args.mode, device=where, policy=args.policy,
                replicas=args.replicas, tenants=served,
                summary=fleet.summary(), modeled=modeled, telemetry=telemetry,
                slo=slo, serving_window=window, launches=launches.snapshot())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=list(MODELS), default="deepsets-32")
    ap.add_argument("--mix", type=str, default=None,
                    help="comma-separated model names served side by side "
                         "(overrides --model)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replicas per tenant, each on its own CUDA stream "
                         "(>1 => FleetServer)")
    ap.add_argument("--policy", choices=["rr", "least_loaded"],
                    default="least_loaded")
    ap.add_argument("--events", type=int, default=256)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--mode", choices=["fused", "unfused"], default="fused",
                    help="unfused: one mm_int8 launch per layer (MLP models; "
                         "DeepSets only with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "PyTorch versions run")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights, the jet stream and the "
                         "arrival RNG")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the fleet's metrics-registry snapshot "
                         "(queue depths, dispatch overheads, rolling "
                         "percentiles, drift ratios) as JSON")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a unified Chrome trace: fleet dispatch/slice "
                         "spans + a short Tier-S sim per tenant")
    ap.add_argument("--drift-gate", type=float, default=None,
                    help="fail (exit 1) when the Tier-A-vs-Tier-S model-path "
                         "drift MAPE exceeds this fraction (e.g. 0.05)")
    ap.add_argument("--arrivals", type=str, default=None,
                    help="open-loop arrival process: closed | poisson:<eps> | "
                         "burst:<eps>[:<cv>] | trace:<file>; rates are "
                         "wall-clock events/sec on this host")
    ap.add_argument("--slo", type=str, default=None,
                    help="per-tenant SLOs: <p99_us>[:<avail>] for every "
                         "tenant or name=<p99_us>[:<avail>],... ; the driver "
                         "exits 1 when any tenant's error budget is "
                         "exhausted")
    ap.add_argument("--slo-window", type=float, default=60.0,
                    help="SLO error-budget accounting window in seconds")
    ap.add_argument("--slo-report-out", type=str, default=None,
                    help="write the cross-tenant SLOReport JSON")
    ap.add_argument("--admission-depth", type=int, default=None,
                    help="shed offered events when every replica queue is "
                         "at/above this depth (None = never shed)")
    args = ap.parse_args(argv)
    if args.events < 1:
        ap.error("--events must be >= 1")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    names = ([s.strip() for s in args.mix.split(",") if s.strip()]
             if args.mix else [args.model])
    for n in names:
        if n not in MODELS:
            ap.error(f"unknown model {n!r} (choices: {list(MODELS)})")
    if len(set(names)) != len(names):
        ap.error(f"--mix has duplicate model names: {names}")
    args.arrival_spec = None
    if args.arrivals:
        try:
            args.arrival_spec = workload.parse_arrivals(args.arrivals)
        except (ValueError, OSError) as exc:
            ap.error(str(exc))
    args.slo_specs = None
    if args.slo:
        try:
            # budgets typed in us (the wall-clock unit the driver prints)
            args.slo_specs = parse_slo(args.slo, names, budget_scale_ns=1e3,
                                       window_s=args.slo_window)
        except ValueError as exc:
            ap.error(str(exc))
    device = resolve_device(args.device)
    if (args.mode == "unfused" and device.type == "cuda"
            and any(MODELS[n]["kind"] == "deepsets" for n in names)):
        ap.error("DeepSets has no per-layer kernel path; --mode unfused "
                 "serves it only with --device cpu")
    preps = {n: _prepare(n, train_steps=args.train_steps, seed=args.seed,
                         device=device)
             for n in names}
    telemetry_requested = (args.metrics_out or args.trace_out
                           or args.drift_gate is not None
                           or args.arrival_spec is not None
                           or args.slo_specs is not None
                           or args.admission_depth is not None)
    if len(names) == 1 and args.replicas == 1 and not telemetry_requested:
        return _serve_single(preps[names[0]], args, device)
    # The telemetry flags route through the fleet path even for one
    # replica: the registry/tracer/drift plumbing lives there.
    return _serve_fleet(preps, args, device)


if __name__ == "__main__":
    main()
