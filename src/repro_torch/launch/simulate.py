"""Tier-S discrete-event simulation driver: execute a placed design and
emit a Chrome trace (load it at chrome://tracing or https://ui.perfetto.dev).

Single tenant — DSE winner, simulated end to end, sim-vs-analytic error:

    PYTHONPATH=src python -m repro_torch.launch.simulate --model deepsets-32

Multi-tenant — replicas packed onto the shared array, ingest contention on
the shim columns under the boxes, contended vs congestion-free events/sec:

    PYTHONPATH=src python -m repro_torch.launch.simulate --model deepsets-32 --replicas 6 --events 8
    PYTHONPATH=src python -m repro_torch.launch.simulate --mix deepsets-32,jsc-m --events 4

Pipelined execution — ``--pipeline-depth D`` admits up to D in-flight
events per instance (D > 1 overlaps the next event's ingest with the
current event's compute); the driver then reports the analytic initiation
interval, the measured steady-state rate, and the bottleneck stage:

    PYTHONPATH=src python -m repro_torch.launch.simulate --model deepsets-32 --pipeline-depth 4 --events 16

Open-loop load — ``--arrivals`` drives each instance with a seeded
arrival process on the cycle clock (rates are modeled-device events/sec);
the driver then reports offered rate and sojourn (arrival-to-completion,
queueing included) statistics next to the closed-loop latency:

    PYTHONPATH=src python -m repro_torch.launch.simulate --model deepsets-32 \\
        --arrivals poisson:2700000 --pipeline-depth 64 --events 2000

``--tier-s`` additionally re-ranks the DSE's top-K designs by simulated
latency (the dse.search rescore hook); ``--seed`` makes jittered and
open-loop runs reproducible (the same grammar and seed produce the same
arrival times here and in ``repro_torch.launch.serve``).

``--engine`` selects the Tier-S engine: ``des`` (default — full
discrete-event simulation with Chrome trace and invariant checks),
``fast`` (the compiled replay engine of :mod:`repro_torch.sim.fastpath` —
bit-exact completion cycles, no trace/profile artifacts), or ``auto``
(fast when supported, DES otherwise). Latency numbers are identical by
construction; choose ``des`` when you need the trace or blame profile.
"""
from __future__ import annotations

import argparse

from repro_torch.core import aie_arch, dse, layerspec, perfmodel, tenancy
from repro_torch.sim import run as simrun

WORKLOADS = {name.lower(): fn
             for name, fn in layerspec.REALISTIC_WORKLOADS.items()}

_EPILOG = """\
deprecations:
  --jitter    deprecated: uniform arrival jitter predates the seeded
              arrival processes and models the same thing less faithfully.
              Use --arrivals instead (poisson:<eps> is the open-loop
              equivalent; a closed-loop run simply omits both flags).
              --jitter still works standalone (with a warning) and is
              ignored when --arrivals is given; it will be removed two
              releases after this deprecation, at which point passing it
              becomes an error.
"""


def _simulate_single(args, cfg: simrun.SimConfig) -> simrun.SimResult:
    spec = WORKLOADS[args.model]()
    design = dse.explore(spec)
    if design is None:
        raise SystemExit(f"no feasible design for {args.model}")
    ana = design.latency.total
    res = simrun.simulate_placement(design.placement, tenant=spec.name,
                                    config=cfg, engine=args.engine)
    is_des = isinstance(res, simrun.SimResult)
    sim = res.latency_cycles
    print(f"[sim] {spec.name}: {design.summary()}")
    if cfg.pipeline_depth <= 1:
        err = abs(sim - ana) / ana
        ev = res.graph.sim.events_run if is_des else res.events_run
        nt = len(res.graph.tasks) if is_des else res.n_tasks
        print(f"[sim] analytic {aie_arch.ns(ana):.1f} ns vs simulated "
              f"{aie_arch.ns(sim):.1f} ns ({100 * err:.2f}% error, "
              f"{ev} engine events, {nt} tasks)")
    else:
        pb = perfmodel.pipeline_stages(design.placement)
        meas = res.instances[0].steady_interval_cycles()
        if cfg.open_loop:
            # Completions pace the *arrivals* when offered rate < 1/II, so
            # the steady interval measures utilization, not the II.
            print(f"[sim] pipelined (depth {cfg.pipeline_depth}): analytic "
                  f"II {aie_arch.ns(pb.interval):.1f} ns (bottleneck stage "
                  f"{pb.bottleneck.name}); open-loop steady interval "
                  f"{aie_arch.ns(meas):.1f} ns tracks the offered rate "
                  f"({100 * aie_arch.ns(pb.interval) / aie_arch.ns(meas):.0f}"
                  f"% utilization)")
        else:
            err = abs(meas - pb.interval) / pb.interval
            print(f"[sim] pipelined (depth {cfg.pipeline_depth}): analytic "
                  f"II {aie_arch.ns(pb.interval):.1f} ns "
                  f"(bottleneck stage {pb.bottleneck.name}) vs measured "
                  f"steady interval {aie_arch.ns(meas):.1f} ns "
                  f"({100 * err:.2f}% error)")
        line = (f"[sim] sustained {res.steady_throughput_eps() / 1e6:.3f} "
                f"Meps vs serial 1/latency {1e3 / aie_arch.ns(ana):.3f} Meps "
                f"({aie_arch.ns(ana) / aie_arch.ns(pb.interval):.2f}x from "
                f"pipelining)")
        if is_des:
            bres, butil = res.bottleneck()
            line += (f"; busiest resource {bres} at "
                     f"{100 * butil:.0f}% utilization")
        print(line)
    return res


def _simulate_tenants(args, cfg: simrun.SimConfig) -> simrun.SimResult:
    if args.mix:
        names = [s.strip() for s in args.mix.split(",") if s.strip()]
        mix = [(n, WORKLOADS[n](), args.replicas) for n in names]
        sched = tenancy.pack_mix(mix)
        if sched is None:
            raise SystemExit(f"mix {names} x{args.replicas} does not fit")
    else:
        design = dse.explore(WORKLOADS[args.model]())
        if design is None:
            raise SystemExit(f"no feasible design for {args.model}")
        sched = tenancy.pack_max_replicas(design, cap=args.replicas)
        if sched is None:
            raise SystemExit(f"{args.model} does not fit the array")
    pipelined = cfg.pipeline_depth > 1
    sc = sched.shim_contention(pipelined=pipelined)
    res = simrun.simulate_schedule(sched, config=cfg, engine=args.engine)
    eps_sim = (res.steady_throughput_eps() if pipelined
               else res.throughput_eps())
    basis = (f"pipelined 1/II (depth {cfg.pipeline_depth})" if pipelined
             else "serial 1/latency")
    print(f"[sim] schedule: {len(sched.instances)} instance(s), "
          f"{sched.total_tiles} tiles, {sched.plio_ports_used} PLIO ports, "
          f"{sc.shared_cols} shim column(s) shared; basis: {basis}")
    print(f"[sim] events/sec: congestion-free {sc.eps_free / 1e6:.2f} Meps | "
          f"analytic contended {sc.eps_contended / 1e6:.2f} Meps | "
          f"simulated {eps_sim / 1e6:.2f} Meps "
          f"({100 * (1 - eps_sim / sc.eps_free):.1f}% sim penalty)")
    if isinstance(res, simrun.SimResult):
        print(f"[sim] shim queueing: {res.shim_wait_cycles():.0f} cycles "
              f"total over {cfg.events} event(s)/instance")
    for inst in res.instances:
        print(f"[sim]   {inst.label}: mean "
              f"{aie_arch.ns(inst.mean_latency_cycles):.1f} ns/event, "
              f"{inst.events_per_sec / 1e6:.3f} Meps")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=_EPILOG)
    ap.add_argument("--model", choices=sorted(WORKLOADS), default="deepsets-32")
    ap.add_argument("--mix", type=str, default=None,
                    help="comma-separated workloads packed side by side "
                         "(overrides --model; --replicas applies per tenant)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replicas to pack (>1 or --mix => multi-tenant sim)")
    ap.add_argument("--events", type=int, default=4,
                    help="events pushed through each instance")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="max in-flight events per instance (1 = serial; "
                         ">1 overlaps next ingest with current compute)")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival RNG seed (reproducible runs)")
    ap.add_argument("--arrivals", type=str, default=None,
                    help="arrival process: closed | poisson:<eps> | "
                         "burst:<eps>[:<cv>] | trace:<file> — rates are "
                         "modeled-device events/sec; open-loop sojourn "
                         "(queueing included) is reported and exported")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="[deprecated] uniform per-event arrival jitter in "
                         "cycles; use --arrivals instead")
    ap.add_argument("--trace", "--trace-out", dest="trace", type=str,
                    default=None,
                    help="Chrome-trace output path "
                         "(default sim_trace_<model|mix>.json)")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the run's metrics-registry snapshot "
                         "(utilization, queueing, latency histograms) as JSON")
    ap.add_argument("--profile-out", type=str, default=None,
                    help="walk back each event's critical path and write the "
                         "per-category blame profile (cycles, shares, "
                         "per-event breakdown, what-if levers) as JSON")
    ap.add_argument("--flame-out", type=str, default=None,
                    help="write folded flamegraph stacks "
                         "(label;stage;category cycles) of the blame profile")
    ap.add_argument("--blame-gate", type=float, default=None,
                    help="exit non-zero when the Tier-A vs Tier-S blame-share "
                         "MAPE (model.blame.* drift family) exceeds this "
                         "fraction (e.g. 0.05)")
    ap.add_argument("--tier-s", action="store_true",
                    help="also re-rank the DSE frontier by simulated latency")
    ap.add_argument("--engine", choices=("des", "auto", "fast"),
                    default="des",
                    help="Tier-S engine: des = full event simulation "
                         "(Chrome trace, profile, invariants); fast = "
                         "compiled replay (bit-exact cycles, no "
                         "artifacts); auto = fast when supported")
    args = ap.parse_args()
    if args.engine != "des" and (args.profile_out or args.flame_out
                                 or args.blame_gate is not None):
        ap.error("--profile-out/--flame-out/--blame-gate need the task "
                 "graph: use --engine des")
    if args.mix:
        for n in args.mix.split(","):
            if n.strip() and n.strip() not in WORKLOADS:
                ap.error(f"unknown workload {n.strip()!r}")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.pipeline_depth < 1:
        ap.error("--pipeline-depth must be >= 1")

    arrivals = None
    if args.arrivals:
        from repro_torch.serve import workload
        try:
            arrivals = workload.parse_arrivals(args.arrivals)
        except (ValueError, OSError) as exc:
            ap.error(str(exc))
        if args.jitter:
            print("[sim] note: --jitter is deprecated and ignored when "
                  "--arrivals is given")
    elif args.jitter:
        print("[sim] note: --jitter is deprecated; prefer --arrivals "
              "(e.g. poisson:<eps>)")

    cfg = simrun.SimConfig(events=args.events, seed=args.seed,
                           jitter_cycles=0.0 if arrivals else args.jitter,
                           pipeline_depth=args.pipeline_depth,
                           arrivals=arrivals,
                           trace=args.engine == "des")
    multi = bool(args.mix) or args.replicas > 1
    res = (_simulate_tenants(args, cfg) if multi
           else _simulate_single(args, cfg))

    if cfg.open_loop:
        s = res.sojourn_summary()
        offered = sum(i.offered_eps for i in res.instances)
        print(f"[sim] open-loop {arrivals.describe()}: offered "
              f"{offered / 1e6:.3f} Meps across {len(res.instances)} "
              f"instance(s)")
        print(f"[sim] sojourn (arrival->completion, queueing included): "
              f"mean {s['mean_ns']:.1f} ns, p50 {s['p50_ns']:.1f} ns, "
              f"p99 {s['p99_ns']:.1f} ns, max {s['max_ns']:.1f} ns "
              f"over {s['events']} post-warmup event(s)")

    if args.tier_s:
        # Independent of the packing: re-rank each involved workload's
        # single-instance DSE frontier by simulated latency.
        names = ([s.strip() for s in args.mix.split(",") if s.strip()]
                 if args.mix else [args.model])
        for n in names:
            fr = dse.search(WORKLOADS[n](), rescore=simrun.rescorer())
            print(f"[sim] Tier-S re-ranked frontier for {n} "
                  f"(tiles, analytic ns, sim ns):")
            for d in fr:
                print(f"[sim]   {d.mapping.total_tiles:4d} tiles  "
                      f"{d.latency.total_ns:8.1f}  {d.sim_latency_ns:8.1f}")

    prof = None
    blame_mape = None
    if (args.profile_out or args.flame_out or args.blame_gate is not None):
        from repro_torch.core.perfmodel import latency_blame
        from repro_torch.obs import profile as obsprofile
        from repro_torch.obs.drift import DriftMonitor

        prof = obsprofile.profile_run(res)
        bad = prof.check()
        if bad:
            raise SystemExit("[sim] blame conservation violations:\n  "
                             + "\n  ".join(bad[:10]))
        shares = prof.blame_shares()
        top3 = sorted(shares.items(), key=lambda kv: -abs(kv[1]))[:3]
        print("[sim] blame (Tier-S critical path): "
              + ", ".join(f"{c} {100 * s:.1f}%" for c, s in top3)
              + f" of {sum(prof.blame_cycles().values()):.0f} cycles")
        levers = obsprofile.top_levers(res)
        if levers:
            lv = levers[0]
            print(f"[sim] top lever: {lv.category} x{lv.factor:g} -> "
                  f"{lv.speedup:.3f}x projected event speedup "
                  f"(what-if replay, waits re-emerge)")
        n_flows = obsprofile.add_flow_events(prof, res.trace)
        mon = DriftMonitor()
        for inst in res.instances:
            obsprofile.feed_blame_drift(
                mon, inst.label, latency_blame(inst.placement),
                prof.blame_cycles(label=inst.label))
        blame_mape = mon.family_mape("model.blame.")
        if blame_mape is not None:
            print(f"[sim] Tier-A vs Tier-S blame-share MAPE "
                  f"{100 * blame_mape:.2f}% over {len(res.instances)} "
                  f"instance(s); {n_flows} critical-path flow arrows traced")
        if args.profile_out:
            import json
            d = prof.as_dict()
            d["blame_mape"] = blame_mape
            d["top_levers"] = [lv.as_dict() for lv in levers]
            with open(args.profile_out, "w") as f:
                json.dump(d, f, indent=1)
            print(f"[sim] blame profile -> {args.profile_out}")
        if args.flame_out:
            with open(args.flame_out, "w") as f:
                f.write(prof.folded())
            print(f"[sim] folded flamegraph stacks -> {args.flame_out}")

    if args.metrics_out:
        reg = res.export_metrics()
        if prof is not None:
            prof.export_metrics(reg)
        reg.save(args.metrics_out,
                 extra={"driver": "simulate",
                        "workload": args.mix or args.model,
                        "events": args.events,
                        "pipeline_depth": args.pipeline_depth})
        print(f"[sim] metrics: {len(reg.all())} series -> {args.metrics_out}")

    if isinstance(res, simrun.SimResult) and res.trace is not None:
        path = args.trace or ("sim_trace_%s.json"
                              % (args.mix.replace(",", "+") if args.mix
                                 else args.model))
        res.trace.meta.update(seed=args.seed, events=args.events)
        res.trace.save(path)
        n_spans = len(res.trace.spans())
        print(f"[sim] Chrome trace: {n_spans} spans -> {path} "
              f"(open in chrome://tracing or ui.perfetto.dev)")
        errs = simrun.invariant_errors(res)
        if errs:
            raise SystemExit("invariant violations:\n  "
                             + "\n  ".join(errs[:10]))
        print("[sim] invariants: clean "
              "(bytes conserved, no double-booking, spans nested)")
    else:
        eng = getattr(res, "engine", "fast")
        print(f"[sim] engine: compiled replay ({eng}) — bit-exact cycles; "
              f"no trace/invariant artifacts (use --engine des for those)")
    if args.blame_gate is not None:
        # After artifacts + trace are written, so a failing run still
        # leaves the evidence on disk for CI to upload.
        if blame_mape is None:
            raise SystemExit("[sim] blame drift gate: no model.blame.* "
                             "entries populated")
        if blame_mape > args.blame_gate:
            raise SystemExit(
                f"[sim] blame drift gate FAILED: Tier-A vs Tier-S "
                f"blame-share MAPE {100 * blame_mape:.2f}% exceeds "
                f"{100 * args.blame_gate:.2f}%")
        print(f"[sim] blame drift gate: PASS "
              f"({100 * blame_mape:.2f}% <= {100 * args.blame_gate:.2f}%)")


if __name__ == "__main__":
    main()
