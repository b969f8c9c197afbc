"""The port's copy of the Tier-S discrete-event simulator of the VEK280
(``repro_torch.sim``) against the JAX package's ``repro.sim``.

Both are pure Python, so every cycle count, stream and span must be equal
with ``==``: the port's simulator on the port's DSE designs against the
reference simulator on the reference's designs, like with like.
"""
import dataclasses

import pytest

from repro.core import dse as rdse
from repro.core import layerspec as rls
from repro.core import tenancy as rten
from repro.core.mapping import Mapping as RMapping
from repro.core.mapping import ModelMapping as RModelMapping
from repro.core.placement import place as rplace
from repro.serve import workload as rwl
from repro.sim import array as rarray
from repro.sim import events as revents
from repro.sim import fastpath as rfast
from repro.sim import run as rrun
from repro.sim import trace as rtrace
from repro_torch.core import dse as tdse
from repro_torch.core import layerspec as tls
from repro_torch.core import tenancy as tten
from repro_torch.core.mapping import Mapping as TMapping
from repro_torch.core.mapping import ModelMapping as TModelMapping
from repro_torch.core.placement import place as tplace
from repro_torch.serve import workload as twl
from repro_torch.sim import array as tarray
from repro_torch.sim import events as tevents
from repro_torch.sim import fastpath as tfast
from repro_torch.sim import run as trun
from repro_torch.sim import trace as ttrace

MODELS = ["jsc-m", "deepsets-32"]
FACTORIES = {"jsc-m": "jsc_m", "deepsets-32": "deepsets_32"}


@pytest.fixture(scope="module")
def designs():
    """name -> (reference design, port design), each ``dse.explore``'s."""
    out = {}
    for name in MODELS:
        f = FACTORIES[name]
        out[name] = (rdse.explore(getattr(rls, f)()),
                     tdse.explore(getattr(tls, f)()))
    return out


def _run_stats(res, stages: bool = True) -> dict:
    """Every measurement stream and statistic of a simulator result (the
    DES's ``SimResult`` or the fast path's ``FastResult``; the latter has
    stage occupancies only when replayed with ``stages=True``)."""
    insts = [dict(label=i.label, roots=list(i.root_cycles),
                  completions=list(i.completion_cycles),
                  arrivals=i.arrivals, latencies=i.latencies,
                  mean=i.mean_latency_cycles, span=i.span_cycles,
                  eps=i.events_per_sec, offered=i.offered_eps,
                  steady=i.steady_interval_cycles(),
                  sojourn=i.sojourn_cycles, waits=i.queue_wait_cycles())
             for i in res.instances]
    return dict(instances=insts, latency=res.latency_cycles,
                latency_ns=res.latency_ns, makespan=res.makespan_cycles,
                eps=res.throughput_eps(), steady=res.steady_throughput_eps(),
                per_instance=res.per_instance_eps(),
                sojourn=res.sojourn_summary(),
                stages=res.stage_occupancy_cycles() if stages else None)


CONFIGS = [dict(events=1), dict(events=6, pipeline_depth=3),
           dict(events=5, jitter_cycles=40.0, seed=3),
           dict(events=4, include_plio=False), dict(events=3, ideal=True)]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()))
def test_simulate_placement_equals_reference(designs, name, cfg):
    r, t = designs[name]
    want = rrun.simulate_placement(r.placement, tenant=name,
                                   config=rrun.SimConfig(**cfg), engine="des")
    got = trun.simulate_placement(t.placement, tenant=name,
                                  config=trun.SimConfig(**cfg), engine="des")
    assert _run_stats(got) == _run_stats(want)
    assert got.bottleneck() == want.bottleneck()
    assert got.shim_wait_cycles() == want.shim_wait_cycles()
    assert trun.invariant_errors(got) == rrun.invariant_errors(want) == []


@pytest.mark.parametrize("name", MODELS)
def test_trace_spans_equal_reference(designs, name):
    r, t = designs[name]
    rtr, ttr = rtrace.ChromeTrace(meta={"m": name}), ttrace.ChromeTrace(
        meta={"m": name})
    rrun.simulate_placement(r.placement, tenant=name,
                            config=rrun.SimConfig(events=3), tracer=rtr)
    trun.simulate_placement(t.placement, tenant=name,
                            config=trun.SimConfig(events=3), tracer=ttr)
    assert ttr.to_dict() == rtr.to_dict()
    assert len(ttr.spans()) > 0


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("cfg", CONFIGS[:3], ids=["serial", "pipelined",
                                                  "jitter"])
def test_compiled_run_equals_des(designs, name, cfg):
    """The port's compiled replay against the port's DES, and against the
    reference's compiled replay."""
    r, t = designs[name]
    des = trun.simulate_placement(t.placement, tenant=name,
                                  config=trun.SimConfig(**cfg), engine="des")
    cr = tfast.compile_placement(t.placement, tenant=name,
                                 config=trun.SimConfig(**cfg))
    fast = tfast.replay(cr, stages=True)
    want = rfast.replay(rfast.compile_placement(
        r.placement, tenant=name, config=rrun.SimConfig(**cfg)), stages=True)
    assert _run_stats(fast) == _run_stats(des)
    assert _run_stats(fast) == _run_stats(want)
    assert fast.engine == want.engine


def test_schedule_simulation_equals_reference(designs):
    """A packed multi-replica schedule, where replicas contend for shim
    columns: the DES and the fast path of both packages."""
    r, t = designs["deepsets-32"]
    rs, ts = rten.pack_max_replicas(r, cap=4), tten.pack_max_replicas(t, cap=4)
    assert len(ts.instances) == len(rs.instances) >= 2
    cfg = dict(events=4, pipeline_depth=2, trace=False)
    for engine in ("des", "fast"):
        want = rrun.simulate_schedule(rs, config=rrun.SimConfig(**cfg),
                                      engine=engine)
        got = trun.simulate_schedule(ts, config=trun.SimConfig(**cfg),
                                     engine=engine)
        assert (_run_stats(got, engine == "des")
                == _run_stats(want, engine == "des")), engine


def test_open_loop_arrivals_equal_reference(designs):
    r, t = designs["jsc-m"]
    for spec in ("poisson:2e6", "burst:2e6:3"):
        want = rrun.simulate_placement(r.placement, config=rrun.SimConfig(
            events=8, pipeline_depth=4, seed=5,
            arrivals=rwl.parse_arrivals(spec)))
        got = trun.simulate_placement(t.placement, config=trun.SimConfig(
            events=8, pipeline_depth=4, seed=5,
            arrivals=twl.parse_arrivals(spec)))
        assert _run_stats(got) == _run_stats(want), spec


def test_sweep_and_rescorer_equal_reference():
    rfr = rdse.search(rls.deepsets_32())
    tfr = tdse.search(tls.deepsets_32())
    want = rrun.sweep_latency_cycles([d.placement for d in rfr], stages=True)
    got = trun.sweep_latency_cycles([d.placement for d in tfr], stages=True)
    assert got == want
    serial = trun.rescorer(workers=0).score_batch(tfr)
    assert serial == rrun.rescorer(workers=0).score_batch(rfr)
    assert trun.rescorer(workers=2, chunk=2).score_batch(tfr) == serial


@pytest.mark.parametrize("m,k,n", [(16, 16, 16), (32, 21, 32), (64, 64, 8)])
def test_single_layer_des_equals_reference(m, k, n):
    """The paper's Table 2 single-AIE layers, placed by hand."""
    def placement(ls, mapping, model_mapping, place):
        layer = ls.LayerSpec(kind="mm", M=m, K=k, N=n, name="t2")
        return place(model_mapping(model=ls.ModelSpec((layer,), name="t2"),
                                   mappings=(mapping(1, 1, 1, layer),)))
    want = rrun.simulate_placement(
        placement(rls, RMapping, RModelMapping, rplace),
        config=rrun.SimConfig(events=2))
    got = trun.simulate_placement(
        placement(tls, TMapping, TModelMapping, tplace),
        config=trun.SimConfig(events=2))
    assert _run_stats(got) == _run_stats(want)


def test_event_engine_equals_reference():
    """The DES core: FIFO and capacity-2 resources, dependencies, delays."""
    def scenario(ev):
        g = ev.TaskGraph()
        one, two = ev.Resource("r"), ev.Resource("s", capacity=2)
        a = g.task("a", duration=10.0, resource=one)
        b = g.task("b", duration=5.0, resource=one)
        c = [g.task(f"c{i}", duration=7.0, resource=two) for i in range(3)]
        d = g.task("d", duration=2.0)
        d.after(a)
        d.after(c[2])
        g.run()
        return ([(x.name, x.start, x.end) for x in [a, b, d] + c],
                one.busy_cycles, one.waits, two.busy_cycles, two.waits)
    assert scenario(tevents) == scenario(revents)


def test_array_resources_equal_reference():
    ra, ta = rarray.ArrayResources(), tarray.ArrayResources()
    for arr in (ra, ta):
        arr.tile(0, 0)
        arr.shim(3, "m")
        arr.edge("e0", "cascade")
    for got, want in ((ta.tile_resources(), ra.tile_resources()),
                      (ta.shim_resources(), ra.shim_resources()),
                      (ta.edge_resources(), ra.edge_resources())):
        assert ({k: (v.name, v.capacity) for k, v in got.items()}
                == {k: (v.name, v.capacity) for k, v in want.items()})
    assert (dataclasses.asdict(trun.SimConfig())
            == dataclasses.asdict(rrun.SimConfig()))
