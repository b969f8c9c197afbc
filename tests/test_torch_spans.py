"""The port's hot-path spans (``repro_torch.kernels._build.spans``, which
``repro_torch.obs.tracing`` re-exports) on the CPU.

With no profiler recording, a K2/K3 wrapper call queries the profiler's
state once and does nothing else for tracing. Under ``torch.profiler`` each
call is a run of flat phase ranges, nested in the caller's range, and the
recorder adds up their counts and host nanoseconds. The card's side (the
launch phase around ``cudaLaunchKernel``) is in ``test_torch_cuda.py``; the
benchmark's readers of the totals are tested in ``portbench/tests``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.kernels import _build
from repro_torch.kernels import cascade_mlp as tcm
from repro_torch.obs import tracing
from repro_torch.quant import quantize_mlp

CALLER = "caller.call"


def _qmlp(rng, dims, relu_last=False):
    ws = [rng.normal(0, 0.4, (dims[i], dims[i + 1]))
          for i in range(len(dims) - 1)]
    bs = [rng.normal(0, 0.1, (d,)) for d in dims[1:]]
    relus = [True] * (len(ws) - 1) + [relu_last]
    return quantize_mlp(ws, bs, relus, rng.normal(0, 1, (64, dims[0])))


def _int8(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))


def _call(wrapper):
    """A CPU call of the wrapper."""
    rng = np.random.default_rng(5)
    if wrapper == "cascade_mlp":
        q, x = _qmlp(rng, [16, 8, 5]), _int8(rng, (7, 16))
        return lambda: tcm.cascade_mlp(x, q)
    phi = _qmlp(rng, [21, 8], relu_last=True)
    rho = _qmlp(rng, [8, 5])
    x = _int8(rng, (3, 5, 21) if wrapper == "deepsets" else (5, 21), -40, 40)
    return lambda: tcm.deepsets(x, phi, rho)


WRAPPERS = ["cascade_mlp", "deepsets", "deepsets_one_set"]


def _events(prof, names):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() in names or e.name().startswith("repro_torch.")]


class _Counting:
    """Stands in for a callable or a lock and counts its uses."""

    def __init__(self, value=None):
        self.n = 0
        self.value = value

    def __call__(self, *a):
        self.n += 1
        return self.value

    def __enter__(self):
        self.n += 1

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_calls_without_a_profiler_record_nothing(wrapper, monkeypatch):
    call = _call(wrapper)
    query = _Counting(False)
    clock, rng, lock = _Counting(0), _Counting(), _Counting()
    monkeypatch.setattr(_build, "recording", query)
    monkeypatch.setattr(_build, "_clock", clock)
    monkeypatch.setattr(_build, "_Range", rng)
    monkeypatch.setattr(_build.spans, "_lock", lock)
    before = _build.spans.totals()
    lock.n = 0
    for _ in range(100):
        call()
    assert query.n == 100
    assert clock.n == rng.n == lock.n == 0
    assert _build.spans.totals() == before


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_a_profiled_call_puts_its_checks_in_the_callers_range(wrapper):
    call = _call(wrapper)
    before = _build.spans.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            call()
    ev = _events(prof, (CALLER,))
    assert sorted(e.name() for e in ev) == [CALLER, "repro_torch.checks"]
    outer, checks = sorted(ev, key=lambda e: e.name())
    assert outer.start_ns() <= checks.start_ns() <= checks.end_ns() \
        <= outer.end_ns()
    after = _build.spans.totals()
    n0, ns0 = before.get("repro_torch.checks", (0, 0))
    assert after["repro_torch.checks"][0] == n0 + 1
    assert after["repro_torch.checks"][1] > ns0
    # The plain version runs in no phase: no other span is counted.
    assert {k for k in after if after[k] != before.get(k)} == {
        "repro_torch.checks"}


@pytest.mark.parametrize("wrapper", ["cascade_mlp", "deepsets"])
def test_a_call_that_raises_closes_its_ranges(wrapper):
    rng = np.random.default_rng(1)
    q = _qmlp(rng, [16, 8, 5])
    bad = torch.zeros((4, 16), dtype=torch.int32)
    before = _build.spans.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            if wrapper == "cascade_mlp":
                tcm.cascade_mlp(bad, q)
            else:
                tcm.deepsets(bad, q, q, agg="max")
        torch.empty(1)      # the profiler goes on past the failed call
    ev = _events(prof, ())
    assert [e.name() for e in ev] == ["repro_torch.checks"]
    assert ev[0].end_ns() >= ev[0].start_ns()
    n0 = before.get("repro_torch.checks", (0, 0))[0]
    assert _build.spans.totals()["repro_torch.checks"][0] == n0 + 1


def test_phases_follow_one_another_on_one_clock_read_a_boundary(monkeypatch):
    ticks = iter([0, 10, 30, 60, 100])
    reads = []

    def clock():
        reads.append(1)
        return next(ticks)
    monkeypatch.setattr(_build, "_clock", clock)
    rec = _build.HotSpans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            span = rec.begin("p1")
            span.phase("p2")
            span.phase(None)
            span.phase("p3")
            span.end()
    assert len(reads) == 5
    assert rec.totals() == {"p1": (1, 10), "p2": (1, 20), "p3": (1, 40)}
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()
          if e.name() in (CALLER, "p1", "p2", "p3")}
    assert ev[CALLER].start_ns() <= ev["p1"].start_ns()
    assert ev["p1"].end_ns() <= ev["p2"].start_ns()
    assert ev["p2"].end_ns() <= ev["p3"].start_ns()
    assert ev["p3"].end_ns() <= ev[CALLER].end_ns()


def test_begin_is_none_without_a_profiler():
    rec = _build.HotSpans()
    assert rec.begin("p1") is None
    assert rec.totals() == {} and rec.mean_us("p1") is None


def test_totals_and_means_by_name():
    rec = _build.HotSpans()
    rec.add_all([("a", 3000), ("b", 1000), ("a", 5000)])
    rec.add("c", 7000)
    assert rec.totals() == {"a": (2, 8000), "b": (1, 1000), "c": (1, 7000)}
    assert rec.mean_us("a") == 4.0 and rec.mean_us("b") == 1.0
    assert rec.mean_us("missing") is None


def test_obs_tracing_names_the_one_recorder():
    assert tracing.spans is _build.spans
    assert tracing.HotSpans is _build.HotSpans


class _FakeLib:
    def __getattr__(self, name):
        fn = _Counting(0)
        setattr(self, name, fn)
        return fn


def test_the_library_load_is_recorded_once_a_process(monkeypatch,
                                                     tmp_path):
    rec = _build.HotSpans()
    monkeypatch.setattr(_build, "spans", rec)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    lib = _build.library()
    assert _build.library() is lib
    assert list(rec.totals()) == ["repro_torch.library"]
    assert rec.totals()["repro_torch.library"][0] == 1


def test_a_build_by_nvcc_says_so_on_stderr(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def run_all(cmds):
        for c in cmds:
            Path(c[c.index("-o") + 1]).write_bytes(b"")
        return ["ok"] * len(cmds)
    monkeypatch.setattr(_build, "_run_all", run_all)
    path = _build.build()
    err = capsys.readouterr().err.splitlines()
    assert path.exists() and len(err) == 1
    assert err[0].startswith(f"repro_torch: built {path} with nvcc in ")
    assert _build.build() == path
    assert capsys.readouterr().err == ""        # found, not built


def test_the_fast_range_is_used_where_torch_has_it():
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    assert _build._Range is (fast or torch.autograd.profiler.record_function)


def _bad_calls():
    """Calls the CPU path refuses, each with the start of its message."""
    rng = np.random.default_rng(9)
    q = _qmlp(rng, [16, 8, 5])
    phi = _qmlp(rng, [21, 8], relu_last=True)
    rho, wide_rho = _qmlp(rng, [8, 5]), _qmlp(rng, [9, 5])
    x16, x21 = _int8(rng, (4, 16)), _int8(rng, (3, 5, 21), -40, 40)
    meta = torch.empty((4, 16), dtype=torch.int8, device="meta")
    return {
        "k2-float": (lambda: tcm.cascade_mlp(x16.float(), q),
                     r"x must be int8 with \(2,\) dims"),
        "k2-3d": (lambda: tcm.cascade_mlp(x16[None], q),
                  r"x must be int8 with \(2,\) dims"),
        "k2-width": (lambda: tcm.cascade_mlp(x16[:, :15], q),
                     "x has 15 features, the model takes 16"),
        "k2-meta": (lambda: tcm.cascade_mlp(meta, q),
                    "tensors on different devices"),
        "k3-agg": (lambda: tcm.deepsets(x21, phi, rho, agg="max"),
                   "agg must be 'mean' or 'sum'"),
        "k3-float": (lambda: tcm.deepsets(x21.float(), phi, rho),
                     r"x must be int8 with \(2, 3\) dims"),
        "k3-width": (lambda: tcm.deepsets(x21[..., :20].contiguous(), phi,
                                          rho),
                     "x has 20 features, the model takes 21"),
        "k3-rho": (lambda: tcm.deepsets(x21, phi, wide_rho),
                   "rho's input width differs from phi's output width"),
        "k3-empty-set": (lambda: tcm.deepsets(x21[:, :0], phi, rho),
                         "deepsets needs at least one set element"),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_the_cpu_path_raises_as_before_and_records_its_checks(case):
    """With the launch plans the CPU path is unchanged: each refused call
    raises its ValueError, in the checks phase alone."""
    call, message = _bad_calls()[case]
    before = _build.spans.totals()
    plans = _build.plans.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match=message):
            call()
    after = _build.spans.totals()
    assert {k for k in after if after[k] != before.get(k)} == {
        "repro_torch.checks"}
    assert after["repro_torch.checks"][0] == \
        before.get("repro_torch.checks", (0, 0))[0] + 1
    assert _build.plans.snapshot() == plans


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_a_cpu_call_builds_no_plan(wrapper):
    call = _call(wrapper)
    plans = _build.plans.snapshot()
    for _ in range(3):
        call()
    assert _build.plans.snapshot() == plans
    assert not tcm.ops._k2_plans and not tcm.ops._k3_plans
