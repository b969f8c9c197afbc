"""The port's fleet serving path against the JAX package's: the arrival
process (``serve.workload``), ``serve.fleet.FleetServer`` and the fleet half
of ``launch.serve``.

``FleetServer(device="cpu")`` serves the kernels' plain versions, and its
gathered outputs must equal the JAX ``FleetServer(interpret=True)``'s bit
for bit; the VEK280-modeled figures (``modeled_throughput``, the
``model.*`` drift entries, ``profile_snapshot``) are pure-Python models and
must be equal with ``==``.
"""
import contextlib
import io
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import layerspec as rls
from repro.data import JetConfig, jet_batch
from repro.launch import serve as rserve
from repro.models import deepsets as jds
from repro.models import mlp as jmlp
from repro.serve import workload as rwl
from repro.serve.fleet import FleetServer as RFleet
from repro.serve.fleet import TenantSpec as RTenant
from repro_torch.core import layerspec as tls
from repro_torch.kernels.cascade_mlp import cascade_mlp_ref, deepsets_ref
from repro_torch.launch import serve as tserve
from repro_torch.quant import QuantizedMLP
from repro_torch.serve import workload as twl
from repro_torch.serve.fleet import FleetServer as TFleet
from repro_torch.serve.fleet import TenantSpec as TTenant


def _quantize_inputs(x, e_in):
    return np.clip(np.round(x / 2.0 ** e_in), -128, 127).astype(np.int8)


@pytest.fixture(scope="module")
def models():
    """Two small tenants (an MLP and a DeepSets), quantized by the JAX
    package, with 6 quantized events each."""
    jc = JetConfig(n_particles=16, n_features=8, n_classes=5, seed=0)
    params = jmlp.mlp_init(jax.random.key(0), 8, [16, 16, 5])
    x, _ = jet_batch(jc, 64, 1)
    q = jmlp.to_quantized(params, x)
    dc = JetConfig(n_particles=8, n_features=21, n_classes=5, seed=0)
    dp = jds.deepsets_init(jax.random.key(1), 21, [16, 16], [16, 5])
    dx, _ = jet_batch(dc, 64, 1)
    qphi, qrho = jds.to_quantized(dp, dx)
    xm, _ = jet_batch(jc, 6, 7)
    xd, _ = jet_batch(dc, 6, 7)
    return {"mlp": (q, None, _quantize_inputs(xm, q.e_in), "jsc_m"),
            "ds": (qphi, qrho, _quantize_inputs(xd, qphi.e_in),
                   "deepsets_32")}


def _twin_fleets(models, **kw):
    """The JAX fleet (fused kernels in interpret mode) and the port's on the
    CPU, two replicas a tenant, each tenant with its Tier-A model spec."""
    jax_t, port_t = [], []
    for name, (q, rho, _, spec) in models.items():
        jax_t.append(RTenant(name=name, qmlp=q, rho=rho, replicas=2,
                             model_spec=getattr(rls, spec)()))
        port_t.append(TTenant(
            name=name, qmlp=QuantizedMLP.from_arrays(q),
            rho=None if rho is None else QuantizedMLP.from_arrays(rho),
            replicas=2, model_spec=getattr(tls, spec)()))
    return (RFleet(jax_t, interpret=True, window_us=50.0, **kw),
            TFleet(port_t, device="cpu", window_us=50.0, **kw))


def test_fleet_matches_jax_fleet(models):
    rf, tf = _twin_fleets(models, policy="rr")
    try:
        for name, (_, _, xq, _) in models.items():
            want = rf.infer_batch(xq, tenant=name, timeout=120)
            got = tf.infer_batch(xq, tenant=name, timeout=120)
            assert got.results.dtype == want.results.dtype
            np.testing.assert_array_equal(got.results, want.results)
            assert got.replica_counts == want.replica_counts == [3, 3]
            for i in range(2):   # rr: one event a replica, in turn
                np.testing.assert_array_equal(
                    tf.infer(xq[i], tenant=name), rf.infer(xq[i], tenant=name))
            assert tf.replica_counts(name) == rf.replica_counts(name)
        assert tf.replica_counts() == rf.replica_counts()
        assert tf.num_replicas == rf.num_replicas == 4
        got_sum, want_sum = tf.summary(), rf.summary()
        for name in models:
            for k in ("n", "replicas", "dispatched"):
                assert got_sum["tenants"][name][k] == want_sum["tenants"][name][k]
    finally:
        rf.close()
        tf.close()


def test_fleet_models_equal_jax_fleet(models):
    """The VEK280-modeled figures: the packed schedule and frontier target,
    the Tier-A vs Tier-S drift entries, and the blame profile."""
    rf, tf = _twin_fleets(models)
    try:
        assert tf.modeled_throughput() == rf.modeled_throughput()
        assert (tf.modeled_throughput(contention="sim", frontier=True)
                == rf.modeled_throughput(contention="sim", frontier=True))
        model = {m: d for m, d in tf.drift_snapshot().summary().items()
                 if m.startswith("model.")}
        want = {m: d for m, d in rf.drift_snapshot().summary().items()
                if m.startswith("model.")}
        assert model == want and set(model) == {"model.latency_ns",
                                                "model.interval_ns"}
        assert tf.profile_snapshot() == rf.profile_snapshot()
        assert (tf.profile_snapshot(events=2, levers=False)
                == rf.profile_snapshot(events=2, levers=False))
    finally:
        rf.close()
        tf.close()


def test_offer_sheds_at_admission_depth(models):
    from repro.obs.slo import SLOSpec as RSLO
    from repro_torch.obs.slo import SLOSpec as TSLO
    q, _, xq, _ = models["mlp"]
    counts = []
    for fleet_cls, spec_cls, qm, kw in (
            (TFleet, TSLO, QuantizedMLP.from_arrays(q), dict(device="cpu")),
            (RFleet, RSLO, q, dict(interpret=True))):
        spec = spec_cls(tenant="m", p99_latency_budget_ns=1e6,
                        availability=0.9, window_s=60.0)
        fleet = fleet_cls([(TTenant if fleet_cls is TFleet else RTenant)(
            name="m", qmlp=qm, mode="ref", replicas=1)],
            slos={"m": spec}, admission_depth=0, **kw)
        try:
            assert all(fleet.offer(x) is None for x in xq[:5])
            reg = fleet.registry
            counts.append([reg.find(f"load.{k}", {"tenant": "m"}).value
                           for k in ("offered", "admitted", "shed")]
                          + [fleet.slo_trackers["m"].shed,
                             fleet.slo_snapshot().meta])
        finally:
            fleet.close()
    assert counts[0] == counts[1] == [5, 0, 5, 5, {"policy": "least_loaded",
                                                   "admission_depth": 0}]


def test_offer_admits_under_depth_and_feeds_telemetry(models):
    q, _, xq, _ = models["mlp"]
    fleet = TFleet([TTenant(name="m", qmlp=QuantizedMLP.from_arrays(q),
                            replicas=2)], device="cpu", admission_depth=64)
    try:
        reqs = [fleet.offer(x) for x in xq]
        assert all(r is not None for r in reqs)
        out = fleet.gather(reqs)
        snap = fleet.telemetry_snapshot(drift=False)
    finally:
        fleet.close()
    qm = QuantizedMLP.from_arrays(q)
    plain = np.stack([cascade_mlp_ref(torch.from_numpy(x), qm).numpy()
                      for x in xq])
    np.testing.assert_array_equal(out, plain)
    hists = {h["name"]: h for h in snap["metrics"]["histograms"]}
    assert hists["fleet.request.latency_us"]["count"] == len(xq)


def test_failed_replica_batch_raises(models):
    """A batch that fails on its replica sets the error on its requests, and
    the fleet raises instead of returning anything in its place."""
    q, _, xq, _ = models["mlp"]
    fleet = TFleet([TTenant(name="m", qmlp=QuantizedMLP.from_arrays(q),
                            replicas=2)], device="cpu")
    try:
        bad = np.zeros((3, 5), np.int8)        # 5 features, the model takes 8
        reqs = fleet.submit_batch([bad, bad], tenant="m")
        with pytest.raises(RuntimeError, match="failed"):
            fleet.gather(reqs, timeout=30)
        # Both replicas' batches failed; none is left to join a later batch.
        assert all(r.event.wait(30) and r.error is not None for r in reqs)
        with pytest.raises(RuntimeError, match="failed"):
            fleet.infer_batch([bad], tenant="m", timeout=30)
        with pytest.raises(RuntimeError, match="failed"):
            fleet.infer(bad, tenant="m")
        np.testing.assert_array_equal(   # the replicas outlive a bad batch
            fleet.infer(xq[0]),
            cascade_mlp_ref(torch.from_numpy(xq[0]),
                            QuantizedMLP.from_arrays(q)).numpy())
    finally:
        fleet.close()


def test_fleet_validates_before_building_replicas(models):
    q, _, _, _ = models["mlp"]
    qm = QuantizedMLP.from_arrays(q)
    with pytest.raises(ValueError, match="duplicate"):
        TFleet([TTenant(name="m", qmlp=qm), TTenant(name="m", qmlp=qm)],
               device="cpu")
    with pytest.raises(ValueError, match="policy"):
        TFleet([TTenant(name="m", qmlp=qm)], policy="random", device="cpu")
    with pytest.raises(ValueError):
        TFleet([TTenant(name="m", qmlp=qm)], device="mps")


ARRIVALS = ["closed", "poisson:2000", "burst:500:3", "burst:800:0.5",
            "burst:100:1"]


@pytest.mark.parametrize("text", ARRIVALS)
def test_arrival_process_equals_reference(text):
    got, want = twl.parse_arrivals(text), rwl.parse_arrivals(text)
    assert got.describe() == want.describe()
    assert got.open_loop == want.open_loop
    for seed in (0, 7):
        assert (twl.arrival_times(got, 50, seed=seed)
                == rwl.arrival_times(want, 50, seed=seed))
    assert twl.arrival_cycles(got, 20) == rwl.arrival_cycles(want, 20)


def test_trace_arrivals_equal_reference(tmp_path):
    path = tmp_path / "arrivals.txt"
    path.write_text("0.0\n0.001\n0.0015\n0.004\n")
    got, want = (twl.parse_arrivals(f"trace:{path}"),
                 rwl.parse_arrivals(f"trace:{path}"))
    assert twl.arrival_times(got, 10) == rwl.arrival_times(want, 10)
    for bad in ("poisson:-1", "burst:10:0", "gamma:4", "poisson"):
        with pytest.raises(ValueError):
            twl.parse_arrivals(bad)
        with pytest.raises(ValueError):
            rwl.parse_arrivals(bad)


class _FakeFleet:
    """Admits every third event's offer as shed; records offers."""

    def __init__(self):
        self.offered = []

    def offer(self, x, tenant=None):
        self.offered.append((int(x), tenant))
        return None if len(self.offered) % 3 == 0 else object()


def _drive(wl):
    now = [0.0]
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        now[0] += s

    def clock():
        now[0] += 1e-5          # every read of the clock costs 10 μs
        return now[0]

    fleet = _FakeFleet()
    dr = wl.drive(fleet, list(range(12)), wl.parse_arrivals("poisson:1000"),
                  tenant="t", seed=3, sleep=sleep, clock=clock)
    return dr.summary(), dr.admitted_idx, sleeps, fleet.offered


def test_drive_on_a_fake_clock_equals_reference():
    got, want = _drive(twl), _drive(rwl)
    assert got == want
    summary, idx, sleeps, offered = got
    assert summary["offered"] == 12
    assert summary["admitted"] + summary["shed"] == summary["offered"]
    assert summary["shed"] == 4 and idx == [0, 1, 3, 4, 6, 7, 9, 10]
    assert len(sleeps) == 12 and offered[0] == (0, "t")


FLEET_ARGV = ["--mix", "deepsets-32,jsc-m", "--replicas", "2", "--events",
              "4", "--train-steps", "1"]


def _tier_a(text):
    return [l for l in text.splitlines() if l.startswith("[fleet] Tier-A")]


def test_fleet_driver_prints_the_reference_tier_a_lines(monkeypatch):
    """``launch.serve --mix --replicas`` on the CPU: the port's outputs equal
    the plain versions on its own quantized models, and its VEK280 lines
    equal the JAX driver's."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = tserve.main(FLEET_ARGV + ["--device", "cpu"])
    port_lines = _tier_a(out.getvalue())
    assert len(port_lines) == 7
    for name, run in rep["tenants"].items():
        xq = torch.from_numpy(run["xq"])
        if run["rho"] is not None:
            plain = deepsets_ref(xq, run["qmlp"], run["rho"])
        else:
            b, m, f = xq.shape
            plain = cascade_mlp_ref(xq.reshape(b * m, f),
                                    run["qmlp"]).reshape(b, m, -1)
        np.testing.assert_array_equal(run["outputs"], plain.numpy())
        assert run["batch"]["replica_counts"] == [2, 2]
        assert run["dispatched"] == [2, 2]
        assert sum(run["batches"]) >= 2
        assert run["streams"] == [None, None]
    assert rep["device"] == "cpu" and rep["launches"] == {}
    monkeypatch.setattr(sys, "argv", ["serve"] + FLEET_ARGV)
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        rserve.main()
    assert port_lines == _tier_a(ref.getvalue())


def test_fleet_driver_open_loop_and_gates(tmp_path):
    """Open loop with admission control, the telemetry files, the drift gate
    and the SLO report, on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = tserve.main([
            "--model", "jsc-m", "--replicas", "2", "--events", "24",
            "--train-steps", "1", "--device", "cpu",
            "--arrivals", "poisson:2000", "--admission-depth", "1",
            "--slo", "1000000:0.01", "--slo-report-out",
            str(tmp_path / "slo.json"), "--metrics-out",
            str(tmp_path / "m.json"), "--trace-out", str(tmp_path / "t.json"),
            "--drift-gate", "0.05"])
    text = out.getvalue()
    ol = rep["tenants"]["jsc-m"]["open_loop"]
    assert ol["admitted"] + ol["shed"] == ol["offered"] == 24
    assert len(rep["tenants"]["jsc-m"]["outputs"]) == ol["admitted"]
    xq = torch.from_numpy(rep["tenants"]["jsc-m"]["xq"][ol["admitted_idx"]])
    b, m, f = xq.shape
    plain = cascade_mlp_ref(xq.reshape(b * m, f),
                            rep["tenants"]["jsc-m"]["qmlp"]).reshape(b, m, -1)
    np.testing.assert_array_equal(rep["tenants"]["jsc-m"]["outputs"],
                                  plain.numpy())
    assert "drift gate: worst model-path MAPE" in text and "PASS" in text
    assert rep["slo"]["ok"] is True
    for f in ("slo.json", "m.json", "t.json"):
        assert (tmp_path / f).stat().st_size > 0


def test_fleet_driver_refuses_bad_flags():
    for argv in (["--replicas", "0"], ["--mix", "jsc-m,jsc-m"],
                 ["--mix", "jsc-m,nope"], ["--arrivals", "gamma:3"],
                 ["--slo", "x"]):
        with pytest.raises(SystemExit):
            tserve.main(argv + ["--device", "cpu", "--train-steps", "0"])
