"""The readers of the port's own spans (``portbench/program_spans.py`` and
the metrics ``port_*_us``, ``library_s``), their entries in BENCHMARK.json,
and ``devtrace.reduce`` beside the port's ranges. A reader reads None from an
empty recorder, or from a program without one (the parent of the recorder).
The test on the card is marked by its fixture and skips without one."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import devtrace, program_spans, spec
from repro_torch.kernels import _build
from repro_torch.obs import tracing

PHASE_METRICS = {"port_checks_us": "repro_torch.checks",
                 "port_pack_us": "repro_torch.pack",
                 "port_alloc_us": "repro_torch.alloc",
                 "port_launch_us": "repro_torch.launch"}
METRICS = ["port_call_us", *PHASE_METRICS, "library_s"]
CELLS = ["deepsets32.trigger", "jscm.trigger"]
HARNESS_GAPS = {"portbench.call", "portbench.copy_out", "portbench.wait",
                "host loop"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _read(name):
    return spec.reader(name).read(None)


def test_the_phases_are_the_metrics_spans_in_order():
    assert program_spans.PHASES == tuple(PHASE_METRICS.values())


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_none_from_an_empty_recorder(name, monkeypatch):
    monkeypatch.setattr(tracing, "spans", _build.HotSpans())
    assert _read(name) is None


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_none_from_a_program_without_the_recorder(
        name, monkeypatch):
    monkeypatch.delattr(tracing, "spans")
    assert _read(name) is None


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_the_means_of_a_filled_recorder(name, monkeypatch):
    rec = _build.HotSpans()
    rec.add("repro_torch.library", 2_500_000_000)
    for i, span in enumerate(PHASE_METRICS.values()):
        rec.add_all([(span, 1000 * (i + 1)), (span, 3000 * (i + 1))])
    monkeypatch.setattr(tracing, "spans", rec)
    want = {"port_call_us": 20.0, "port_checks_us": 2.0,
            "port_pack_us": 4.0, "port_alloc_us": 6.0,
            "port_launch_us": 8.0, "library_s": 2.5}[name]
    assert _read(name) == pytest.approx(want)


def test_a_call_of_the_plain_version_is_its_checks(monkeypatch):
    rec = _build.HotSpans()
    rec.add_all([("repro_torch.checks", 3000), ("repro_torch.checks", 5000)])
    monkeypatch.setattr(tracing, "spans", rec)
    assert _read("port_call_us") == pytest.approx(4.0)
    assert _read("port_launch_us") is None


@pytest.mark.parametrize("cell", CELLS)
def test_both_cells_report_the_six_span_metrics(cell):
    listed = {m["name"]: m for m in spec.per_layer(spec.benchmark(), cell)}
    for name in METRICS:
        m = listed[name]
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert set(CELLS) <= set(m["workloads"])
        assert (m["unit"], m["moves"]) == (
            ("s", "setup_s") if name == "library_s"
            else ("us", "latency_p95_us"))
    for name, span in PHASE_METRICS.items():
        assert span in listed[name]["layer"]
    assert "repro_torch.library" in listed["library_s"]["layer"]


def _idle_gap_names(events):
    return {n for n, _ in devtrace.reduce(events)["breakdown"]["idle_gaps"]}


def test_devtrace_reads_only_the_harness_phases_around_the_spans():
    """The port's ranges nest inside ``portbench.call``; today's breakdown
    shares idle gaps among the harness's phases alone."""
    rec = _build.HotSpans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            for _ in range(5):
                with record_function("portbench.call"):
                    span = rec.begin("repro_torch.checks")
                    span.phase("repro_torch.launch")
                    torch.empty(1)
                    span.end()
                with record_function("portbench.wait"):
                    pass
    events = prof.profiler.kineto_results.events()
    assert sum(e.name() == "repro_torch.launch" for e in events) == 5
    names = _idle_gap_names(events)
    assert "portbench.call" in names and names <= HARNESS_GAPS
    assert devtrace.reduce(events)["busy_s"] == 0.0


@pytest.mark.parametrize("wrapper", ["cascade_mlp", "deepsets"])
def test_devtrace_on_the_card_beside_the_wrappers_spans(card, wrapper):
    """A K2/K3 call's phases, nested in ``portbench.call``, change nothing of
    the breakdown: its idle gaps name the harness's phases, and the device
    time is the kernel's alone."""
    from repro_torch.kernels import cascade_mlp as tcm
    from repro_torch.quant import quantize_mlp
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)

    def qmlp(dims, relu_last=False):
        ws = [torch.randn(a, b, generator=g).double().numpy() * 0.4
              for a, b in zip(dims, dims[1:])]
        bs = [torch.randn(b, generator=g).double().numpy() * 0.1
              for b in dims[1:]]
        relus = [True] * (len(ws) - 1) + [relu_last]
        calib = torch.randn(64, dims[0], generator=g).double().numpy()
        return quantize_mlp(ws, bs, relus, calib).to(dev)

    def int8(shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int8).to(dev)

    if wrapper == "cascade_mlp":
        q, x = qmlp([16, 64, 32, 32, 32, 5]), int8((64_000, 16))
        kernel = "cascade_mlp_kernel"

        def call():
            return tcm.cascade_mlp(x, q)
    else:
        phi = qmlp([21, 32, 32, 32], relu_last=True)
        rho = qmlp([32, 32, 10])
        x = int8((1000, 32, 21), -40, 40)
        kernel = "deepsets_kernel"

        def call():
            return tcm.deepsets(x, phi, rho)
    call()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            for _ in range(20):
                with record_function("portbench.call"):
                    call()
                with record_function("portbench.wait"):
                    torch.cuda.synchronize(dev)
    events = prof.profiler.kineto_results.events()
    assert sum(e.name() == "repro_torch.launch" for e in events) == 20
    names = _idle_gap_names(events)
    assert "portbench.call" in names and names <= HARNESS_GAPS
    r = devtrace.reduce(events)
    assert set(r["kernels"]) == {kernel} and r["kernels"][kernel][1] == 20
