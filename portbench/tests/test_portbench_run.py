"""The harness's parts that need no card: the exit without one, the seeded
sample of outputs, the trace's reduction, and each metric's reader on a
run built by hand. Runs on the card are in ``test_portbench_cuda.py``."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, roofline, run, spec, window

ROOT = Path(spec.__file__).resolve().parents[1]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", str(2 ** 31 + 1), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_the_sample_is_drawn_from_the_seed():
    def kept(seed):
        s = window.Sample(4, seed)
        for i in range(1000):
            s.offer(i, i % 16, i)
        return [o for _, o in s.kept]
    assert kept(7) == kept(7) != kept(8)
    assert max(kept(7)) >= 4   # later calls are drawn too


def test_the_sample_copies_a_reused_buffer():
    s = window.Sample(2, 1)
    buf = torch.zeros(3)
    s.offer(0, 0, buf, copy=True)
    buf += 1
    assert torch.equal(s.kept[0][1], torch.zeros(3))


class _Ev(SimpleNamespace):
    def name(self):
        return self.n

    def device_type(self):
        return SimpleNamespace(name=self.dev)

    def activity_type(self):
        return self.kind

    def is_user_annotation(self):
        return self.kind.endswith("user_annotation")

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def test_the_trace_reduction():
    k = "(anonymous namespace)::deepsets_kernel(signed char const*, int)"
    evs = [
        _Ev(n="portbench.window", dev="CPU", kind="user_annotation",
            s=0, e=1000),
        _Ev(n="portbench.call", dev="CPU", kind="user_annotation", s=0,
            e=100),
        _Ev(n="portbench.copy_out", dev="CPU", kind="user_annotation",
            s=500, e=700),
        _Ev(n="portbench.window", dev="CUDA", kind="gpu_user_annotation",
            s=0, e=1000),
        _Ev(n=k, dev="CUDA", kind="kernel", s=100, e=400),
        _Ev(n=k, dev="CUDA", kind="kernel", s=350, e=500),
        _Ev(n="Memcpy DtoH (Device -> Pageable)", dev="CUDA",
            kind="gpu_memcpy", s=600, e=650),
        _Ev(n="cudaLaunchKernel", dev="CPU", kind="cuda_runtime", s=90,
            e=95),
    ]
    t = devtrace.reduce(evs)
    assert t["window_s"] == pytest.approx(1000e-9)
    assert t["busy_s"] == pytest.approx(450e-9)      # 100..500, 600..650
    assert t["kernels"]["deepsets_kernel"] == (pytest.approx(450e-9), 2)
    gaps = dict(t["breakdown"]["idle_gaps"])
    assert gaps["portbench.call"] == pytest.approx(100e-9)
    # 500..600 and 650..700 under the copy; 650..1000 partly outside it.
    assert gaps["portbench.copy_out"] == pytest.approx(150e-9)
    assert gaps["host loop"] == pytest.approx(300e-9)
    assert devtrace.idle_share(t) == pytest.approx(55.0)
    assert t["breakdown"]["device_ops"][0][0] == "deepsets_kernel"


def test_the_trace_reduction_without_activity_types():
    """Older torch: events without ``activity_type``."""
    class Old(_Ev):
        activity_type = None
    evs = [Old(n="portbench.window", dev="CPU", kind="user_annotation",
               s=0, e=100),
           Old(n="portbench.window", dev="CUDA", kind="gpu_user_annotation",
               s=0, e=100),
           Old(n="k(int)", dev="CUDA", kind="kernel", s=10, e=30)]
    t = devtrace.reduce(evs)
    assert t["busy_s"] == pytest.approx(20e-9)
    assert list(t["kernels"]) == ["k"]


def _hand_built_run(kind="deepsets", trace=None):
    cfg = spec.config({"deepsets": "deepsets-32", "mlp": "jsc-m"}[kind])
    w = window.Window(seconds=2.0, issued=100, done=98,
                      latencies_us=[float(v) for v in range(1, 101)],
                      call_s=0.004)
    return run.Run(config=cfg, traffic={}, ref=spec.reference(kind),
                   batch_events=1000,
                   peak=roofline.peaks("NVIDIA H100 80GB HBM3", "int8"),
                   setup_s=7.5, window=w, launches=100, trace=trace)


def _read(name, r):
    return spec.reader(name).read(r)


def test_the_window_readers():
    r = _hand_built_run()
    assert _read("events_per_s", r) == pytest.approx(98 * 1000 / 2.0)
    assert _read("mfu", r) == pytest.approx(
        100 * 98 * 1000 * 177_792 / (2.0 * 1979e12))
    assert _read("latency_p95_us", r) == pytest.approx(95.05)
    assert _read("call_us.trigger", r) == pytest.approx(40.0)
    assert _read("launches_per_batch", r) == 1.0
    assert _read("setup_s", r) == 7.5
    r.window.latencies_us = []
    assert _read("latency_p95_us", r) is None


@pytest.mark.parametrize("kind,metric,kernel,bytes_", [
    ("deepsets", "k3_roofline", "deepsets_kernel", 1000 * 682 + 4616),
    ("mlp", "k2_roofline", "cascade_mlp_kernel", 1000 * 1344 + 5940)])
def test_the_roofline_readers(kind, metric, kernel, bytes_):
    trace = {"busy_s": 0.5, "window_s": 2.0,
             "kernels": {kernel: (40 * 10e-6, 40)}}
    r = _hand_built_run(kind, trace)
    assert _read(metric, r) == pytest.approx(
        100 * bytes_ / 3.35e12 / 10e-6)
    assert _read("idle_share.trigger", r) == pytest.approx(75.0)
    # Nothing to read: no trace, or the kernel not in it.
    other = "k2_roofline" if metric == "k3_roofline" else "k3_roofline"
    assert _read(other, r) is None
    r.trace = None
    assert _read(metric, r) is None
    assert _read("idle_share.trigger", r) is None
