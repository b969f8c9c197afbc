"""The port's copy of the observability layer (``repro_torch.obs``) against the
JAX package's ``repro.obs``.

Metrics, tracing, SLO accounting and drift use only the standard library,
and the profiler walks the Tier-S simulator's tasks, so every quantile,
snapshot, budget and blame share must be equal with ``==`` on the same
inputs. Time never comes from the host clock: the SLO trackers take an
injected ``t``/``now`` and the spans explicit timestamps.
"""
import numpy as np
import pytest

from repro.core import dse as rdse
from repro.core import layerspec as rls
from repro.core import perfmodel as rpm
from repro.obs import drift as rdrift
from repro.obs import metrics as rmet
from repro.obs import profile as rprof
from repro.obs import slo as rslo
from repro.obs import tracing as rtrc
from repro.sim import run as rrun
from repro.sim import trace as rtrace
from repro_torch.core import dse as tdse
from repro_torch.core import layerspec as tls
from repro_torch.core import perfmodel as tpm
from repro_torch.obs import drift as tdrift
from repro_torch.obs import metrics as tmet
from repro_torch.obs import profile as tprof
from repro_torch.obs import slo as tslo
from repro_torch.obs import tracing as ttrc
from repro_torch.sim import run as trun
from repro_torch.sim import trace as ttrace
from test_torch_core import _norm

SEED = 0


def _stream(n=2000, seed=SEED):
    """One seeded latency stream (lognormal around 300 μs, a heavy tail)."""
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(np.log(300.0), 0.6, n)]


@pytest.mark.parametrize("p", [0.5, 0.9, 0.99])
def test_p2_quantile_equals_reference(p):
    got, want = tmet.P2Quantile(p), rmet.P2Quantile(p)
    for i, x in enumerate(_stream()):
        got.observe(x)
        want.observe(x)
        if i in (0, 3, 4, 5, 99, 1999):
            assert got.value == want.value, i


@pytest.mark.parametrize("buckets", [None, (1.0, 10.0, 100.0, 1000.0)],
                         ids=["default", "coarse"])
def test_histogram_equals_reference(buckets):
    got = tmet.Histogram("lat", (), buckets=buckets)
    want = rmet.Histogram("lat", (), buckets=buckets)
    xs = _stream()
    for x in xs:
        got.record(x)
        want.record(x)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q), q
        assert got.bucket_quantile(q) == want.bucket_quantile(q), q
    assert got.mean == want.mean
    assert got.as_dict() == want.as_dict()
    other_t, other_r = (tmet.Histogram("lat", (), buckets=buckets),
                        rmet.Histogram("lat", (), buckets=buckets))
    for x in _stream(300, seed=1):
        other_t.record(x)
        other_r.record(x)
    got.merge(other_t)
    want.merge(other_r)
    assert got.as_dict() == want.as_dict()


def _fill(mod):
    reg = mod.MetricsRegistry()
    for i, x in enumerate(_stream(500)):
        reg.histogram("fleet.request.latency_us",
                      {"tenant": "ab"[i % 2]}).record(x)
        reg.counter("load.offered", {"tenant": "ab"[i % 2]}).inc()
    reg.gauge("fleet.replica.queue_depth", {"tenant": "a", "replica": "0"}).set(3)
    reg.gauge("calib.sweep.points").inc(2.5)
    return reg


def test_registry_equals_reference(tmp_path):
    got, want = _fill(tmet), _fill(rmet)
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_json(sort_keys=True) == want.to_json(sort_keys=True)
    assert (got.merge(_fill(tmet)).snapshot()
            == want.merge(_fill(rmet)).snapshot())
    a = got.save(str(tmp_path / "t.json"), extra={"x": 1})
    b = want.save(str(tmp_path / "r.json"), extra={"x": 1})
    assert open(a).read() == open(b).read()


def _spans(mod):
    tr = mod.Tracer(meta={"driver": "serve"})
    tr.span_us("fleet", "m.dispatch", "infer_batch[6]", 10.0, 250.0,
               cat="fleet", args={"replica_counts": [3, 3]})
    tr.span_us("fleet", "m#0", "slice[3]", 12.0, 120.0, cat="slice")
    tr.instant_us("events", "e0", "arrive", 5.0)
    tr.flow_us("tiles", "r0 c00", "cp", 20.0, id=1, phase="s")
    tr.flow_us("tiles", "r0 c01", "cp", 40.0, id=1, phase="f")
    return tr


def test_tracer_equals_reference(tmp_path):
    got, want = _spans(ttrc), _spans(rtrc)
    assert got.to_dict() == want.to_dict()
    assert got.spans("fleet") == want.spans("fleet")
    path = got.save(str(tmp_path / "t.json"))
    assert ttrc.load(path) == rtrc.load(path)
    with pytest.raises(ValueError):
        got.flow_us("a", "b", "c", 0.0, id=1, phase="x")


SLO_GRAMMAR = ["50000:0.99", "a=1000:0.9,b=2000", "750"]


@pytest.mark.parametrize("text", SLO_GRAMMAR)
def test_parse_slo_equals_reference(text):
    got = tslo.parse_slo(text, ["a", "b"], budget_scale_ns=1e3, window_s=30.0)
    want = rslo.parse_slo(text, ["a", "b"], budget_scale_ns=1e3, window_s=30.0)
    assert {k: v.as_dict() for k, v in got.items()} == \
        {k: v.as_dict() for k, v in want.items()}


def _slo_run(met, slo):
    """A tenant whose latency degrades half way through a 120 s window,
    recorded on an injected clock (t in seconds)."""
    reg = met.MetricsRegistry()
    spec = slo.SLOSpec(tenant="a", p99_latency_budget_ns=400e3,
                       availability=0.99, window_s=120.0)
    tr = slo.SLOTracker(spec, registry=reg)
    snaps = []
    for i, x in enumerate(_stream(1200)):
        t = i * 0.1
        tr.record(x * (1.0 if t < 60 else 1.6) * 1e3, t=t)
        if i % 97 == 0:
            tr.record_shed(t=t)
        if i % 300 == 299:
            snaps.append(tr.snapshot(now=t))
    report = slo.SLOReport.from_trackers({"a": tr}, now=119.9,
                                         meta={"policy": "rr"})
    return (snaps, [a.as_dict() for a in tr.alerts(now=119.9)],
            tr.error_budget_remaining(now=119.9), report.as_dict(),
            report.ok, report.exit_code(), reg.snapshot())


def test_slo_tracker_equals_reference():
    got, want = _slo_run(tmet, tslo), _slo_run(rmet, rslo)
    assert got == want
    assert got[1], "the degraded half must raise a burn-rate alert"


def _drift(mod):
    m = mod.DriftMonitor()
    for i, x in enumerate(_stream(40)):
        key = f"t#{i % 4}"
        m.expect(key, "serve.latency_us", 0.6)
        m.observe(key, "serve.latency_us", x)
    m.expect("t", "model.latency_ns", 591.1)
    m.observe("t", "model.latency_ns", 591.1)
    m.expect("t", "model.interval_ns", 259.0)
    m.observe("t", "model.interval_ns", 271.0)
    m.expect("d/shim", "model.stage.shim", 100.0)
    m.observe("d/shim", "model.stage.shim", 140.0)
    return m


def test_drift_monitor_equals_reference():
    got, want = _drift(tdrift), _drift(rdrift)
    assert got.summary() == want.summary()
    assert got.mape() == want.mape()
    assert got.family_mape("model.") == want.family_mape("model.")
    assert _norm(got.flagged(0.05)) == _norm(want.flagged(0.05))
    assert _norm(got.localize(0.05)) == _norm(want.localize(0.05))
    assert got.metrics() == want.metrics()


@pytest.fixture(scope="module")
def sim_runs():
    """(reference, port) simulator runs of deepsets-32's DSE design, three
    pipelined events, and the two designs."""
    r = rdse.explore(rls.deepsets_32())
    t = tdse.explore(tls.deepsets_32())
    cfg = dict(events=3, pipeline_depth=2, trace=False)
    return (rrun.simulate_placement(r.placement, config=rrun.SimConfig(**cfg)),
            trun.simulate_placement(t.placement, config=trun.SimConfig(**cfg)),
            r, t)


def test_profile_equals_reference(sim_runs):
    rres, tres, r, t = sim_runs
    want, got = rprof.profile_run(rres), tprof.profile_run(tres)
    assert got.blame_cycles() == want.blame_cycles()
    assert got.blame_shares() == want.blame_shares()
    assert got.analytic_shares() == want.analytic_shares()
    assert got.check() == want.check() == []
    assert got.table() == want.table()
    assert got.folded() == want.folded()
    assert got.as_dict() == want.as_dict()
    assert (got.export_metrics().snapshot()
            == want.export_metrics().snapshot())
    assert (tprof.annotated_categories(tres)
            == rprof.annotated_categories(rres))
    assert ([w.as_dict() for w in tprof.top_levers(tres)]
            == [w.as_dict() for w in rprof.top_levers(rres)])
    tm, rm = tdrift.DriftMonitor(), rdrift.DriftMonitor()
    tprof.feed_blame_drift(tm, "ds", tpm.latency_blame(t.placement),
                           got.blame_cycles())
    rprof.feed_blame_drift(rm, "ds", rpm.latency_blame(r.placement),
                           want.blame_cycles())
    assert tm.summary() == rm.summary()


def test_profile_flow_events_equal_reference():
    r = rdse.explore(rls.jsc_m())
    t = tdse.explore(tls.jsc_m())
    rtr, ttr = rtrace.ChromeTrace(), ttrace.ChromeTrace()
    rres = rrun.simulate_placement(r.placement, tracer=rtr,
                                   config=rrun.SimConfig(events=2))
    tres = trun.simulate_placement(t.placement, tracer=ttr,
                                   config=trun.SimConfig(events=2))
    rprof.add_flow_events(rprof.profile_run(rres), rtr)
    tprof.add_flow_events(tprof.profile_run(tres), ttr)
    assert ttr.to_dict() == rtr.to_dict()


# Fixed chains in place of the hypothesis draws of
# tests/test_profile_properties.py (M, widths, biases).
CHAINS = [(8, [5, 8], [True]), (16, [16, 32, 5], [False, True]),
          (32, [21, 32, 32, 10], [True, True, False]),
          (64, [64, 16, 8, 21, 5], [True, False, True, True]),
          (16, [8, 64, 64, 32, 16, 5], [True] * 5)]


@pytest.mark.parametrize("m,dims,bias", CHAINS,
                         ids=lambda v: str(v).replace(" ", ""))
def test_single_event_critical_path_is_makespan(m, dims, bias):
    """One event's critical path is the whole schedule, in the port and the
    reference alike, and the port's blame equals the reference's."""
    results = []
    for ls, dse, run, prof in ((tls, tdse, trun, tprof),
                               (rls, rdse, rrun, rprof)):
        layers = tuple(ls.LayerSpec(kind="mm", M=m, K=dims[i], N=dims[i + 1],
                                    bias=bias[i], relu=i < len(bias) - 1,
                                    name=f"l{i}")
                       for i in range(len(bias)))
        design = dse.explore(ls.ModelSpec(layers, name="chain"))
        assert design is not None
        res = run.simulate_placement(design.placement,
                                     config=run.SimConfig(trace=False))
        ep = prof.profile_run(res).events[0]
        assert ep.critical_path_cycles == res.latency_cycles
        assert ep.sojourn_cycles == res.makespan_cycles
        results.append((ep.critical_path_cycles, ep.sojourn_cycles,
                        ep.blame()))
    assert results[0] == results[1]
