"""The port's copies of the multi-tenant scheduler (``core.tenancy``) and the
overhead calibration (``core.calibrate``) against the JAX package's.

Both are numpy/pure-Python models of the VEK280, so every result must be
equal with ``==``: frontiers, packings, the M/D/1 queueing curves of
``tests/test_queueing.py``, and the calibration's fits.
"""
import math

import numpy as np
import pytest

from repro.core import aie_arch as rarch
from repro.core import calibrate as rcal
from repro.core import dse as rdse
from repro.core import layerspec as rls
from repro.core import perfmodel as rpm
from repro.core import tenancy as rten
from repro.obs import DriftMonitor as RDrift
from repro.serve import workload as rwl
from repro_torch.core import aie_arch as tarch
from repro_torch.core import calibrate as tcal
from repro_torch.core import dse as tdse
from repro_torch.core import layerspec as tls
from repro_torch.core import perfmodel as tpm
from repro_torch.core import tenancy as tten
from repro_torch.obs import DriftMonitor as TDrift
from repro_torch.serve import workload as twl
from test_torch_core import _norm

MODELS = {"jsc-m": "jsc_m", "deepsets-32": "deepsets_32"}


def _spec(ls, name):
    return getattr(ls, MODELS[name])()


@pytest.fixture(scope="module")
def designs():
    return {n: (rdse.explore(_spec(rls, n)), tdse.explore(_spec(tls, n)))
            for n in MODELS}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("kw", [dict(), dict(pipelined=False),
                                dict(contention="none"),
                                dict(contention="sim", sim_events=4)],
                         ids=["analytic", "serial", "free", "sim"])
def test_throughput_frontier_equals_reference(name, kw):
    want = rten.throughput_frontier(_spec(rls, name), **kw)
    got = tten.throughput_frontier(_spec(tls, name), **kw)
    assert len(got) == len(want) > 0
    assert [p.as_dict() for p in got] == [p.as_dict() for p in want]
    assert _norm(got) == _norm(want)


def test_pack_mix_equals_reference():
    mix = [("deepsets-32", 4), ("jsc-m", 4)]
    want = rten.pack_mix([(n, _spec(rls, n), r) for n, r in mix])
    got = tten.pack_mix([(n, _spec(tls, n), r) for n, r in mix])
    assert got.summary() == want.summary()
    assert _norm(got) == _norm(want)
    assert got.validate() == want.validate() == []
    for pipelined in (True, False):
        assert (_norm(got.shim_contention(pipelined=pipelined))
                == _norm(want.shim_contention(pipelined=pipelined)))
        assert (got.throughput_eps(pipelined=pipelined)
                == want.throughput_eps(pipelined=pipelined))
    for n, _ in mix:
        for rate in (1e6, 5e6):
            assert (_norm(tten.tenant_latency_under_load(got, n, rate))
                    == _norm(rten.tenant_latency_under_load(want, n, rate)))


@pytest.mark.parametrize("name", list(MODELS))
def test_packer_equals_reference(designs, name):
    r, t = designs[name]
    assert tten.max_replicas(t) == rten.max_replicas(r)
    for n in (1, 3):
        assert (_norm(tten.pack_replicas(t, n))
                == _norm(rten.pack_replicas(r, n)))
    assert (_norm(tten.pack_max_replicas(t, cap=6))
            == _norm(rten.pack_max_replicas(r, cap=6)))
    assert (_norm(tten.pack([(name, t), ("b", t)]))
            == _norm(rten.pack([(name, r), ("b", r)])))
    assert (tten.shim_transfer_cycles(t.placement)
            == rten.shim_transfer_cycles(r.placement))
    assert (tten.shim_split_cycles(t.placement)
            == rten.shim_split_cycles(r.placement))


RATES = [0.0, 0.3, 0.7, 0.95, 1.0, 1.2]


def test_md1_curves_equal_reference():
    """The M/D/1 mean, CDF (with its decimal fallback) and quantiles on a
    grid, the curves of ``tests/test_queueing.py``."""
    for rho in RATES:
        assert tten.md1_mean_wait_s(rho, 1.0) == rten.md1_mean_wait_s(rho, 1.0)
        for t in (-1.0, 0.0, 0.5, 1.0, 2.5, 7.0, 60.0):
            assert (tten.md1_wait_cdf(t, rho, 1.0)
                    == rten.md1_wait_cdf(t, rho, 1.0)), (t, rho)
        if rho > 0:
            for q in (0.5, 0.9, 0.99, 0.999):
                assert (tten.md1_wait_quantile_s(q, rho, 1.0)
                        == rten.md1_wait_quantile_s(q, rho, 1.0)), (q, rho)
    for mod in (tten, rten):
        with pytest.raises(ValueError):
            mod.md1_mean_wait_s(0.5, 0.0)
        with pytest.raises(ValueError):
            mod.md1_wait_quantile_s(0.0, 0.7, 1.0)
    assert tten.md1_mean_wait_s(1.0, 1.0) == math.inf


def test_queueing_under_load_equals_reference(designs):
    """Lindley waits on one seeded trace, their summary, and the Monte
    Carlo latency-under-load curve and SLO rate search."""
    r, t = designs["deepsets-32"]
    pb = tpm.pipeline_stages(t.placement)
    assert pb.interval == rpm.pipeline_stages(r.placement).interval
    rate = 0.7 * 1e9 / tarch.ns(pb.interval)
    times = twl.arrival_times(twl.poisson(rate), 400, seed=2)
    assert times == rwl.arrival_times(rwl.poisson(rate), 400, seed=2)
    cycles = twl.arrival_cycles(twl.trace(times), 400)
    assert cycles == rwl.arrival_cycles(rwl.trace(times), 400)
    split = tten.shim_split_cycles(t.placement)
    for sp in (None, split):
        got = tten.bottleneck_waits_cycles(
            cycles, interval_cycles=pb.interval,
            latency_cycles=t.latency.total, shim_split=sp)
        want = rten.bottleneck_waits_cycles(
            cycles, interval_cycles=pb.interval,
            latency_cycles=r.latency.total, shim_split=sp)
        assert got == want
        assert (tten.summarize_waits(got, t.latency.total)
                == rten.summarize_waits(want, r.latency.total))
    ii, lat = rarch.ns(pb.interval), r.latency.total_ns
    for kw in (dict(), dict(replicas=2), dict(shim_split_ns=(40.0, 30.0))):
        for rho in (0.2, 0.8, 1.1):
            got = tten.latency_under_load(rho * 1e9 / ii, interval_ns=ii,
                                          latency_ns=lat, mc_events=4000, **kw)
            want = rten.latency_under_load(rho * 1e9 / ii, interval_ns=ii,
                                           latency_ns=lat, mc_events=4000, **kw)
            assert got.as_dict() == want.as_dict()
        assert (tten.max_rate_for_slo(3 * lat, interval_ns=ii, latency_ns=lat,
                                      mc_events=2000, **kw)
                == rten.max_rate_for_slo(3 * lat, interval_ns=ii,
                                         latency_ns=lat, mc_events=2000, **kw))


def test_calibration_equals_reference():
    """The sweep, the simulated measurements, the least-squares fit and the
    telemetry it writes."""
    tpts, rpts = tcal.default_sweep(), rcal.default_sweep()
    assert ([(p.name, p.family) for p in tpts]
            == [(p.name, p.family) for p in rpts])
    assert _norm(tcal.predict_cycles(tpts)) == _norm(rcal.predict_cycles(rpts))
    tx, ty = tcal.design_matrix(tpts), rcal.design_matrix(rpts)
    assert _norm(tx) == _norm(ty)
    got, treg, tmon, tdrift = tcal.run_calibration()
    want, rreg, rmon, rdrift = rcal.run_calibration()
    assert got.as_dict() == want.as_dict()
    assert _norm(got.fitted) == _norm(want.fitted)
    assert got.gate_errors() == want.gate_errors()
    assert tdrift == rdrift
    assert treg.snapshot() == rreg.snapshot()
    assert tmon.summary() == rmon.summary()
    # A fit to perturbed measurements moves the same constants the same way.
    rng = np.random.default_rng(0)
    noise = rng.uniform(0.97, 1.03, len(tpts))
    meas = [c * f for c, f in zip(tcal.predict_cycles(tpts), noise)]
    assert (tcal.fit(tpts, meas).as_dict()
            == rcal.fit(rpts, meas).as_dict())


def test_stage_suspects_localize_equal_reference():
    """``obs.drift`` reads ``core.calibrate.STAGE_SUSPECTS`` lazily to name
    the constants behind a drifted stage."""
    assert tcal.STAGE_SUSPECTS == rcal.STAGE_SUSPECTS
    mons = []
    for mod in (TDrift, RDrift):
        m = mod()
        m.expect("a/shim", "model.stage.shim", 100.0)
        m.observe("a/shim", "model.stage.shim", 130.0)
        m.expect("a/comp", "model.stage.comp", 50.0)
        m.observe("a/comp", "model.stage.comp", 50.5)
        mons.append(m)
    assert _norm(mons[0].localize(0.05)) == _norm(mons[1].localize(0.05))
    assert mons[0].summary() == mons[1].summary()
