"""The reader of the port's launch-plan counter (``metrics/plan_hit_share.py``)
and its entry in BENCHMARK.json. It reads None from a program without the
counter (the parent of the plans) or with no launch of a planned kernel."""
from __future__ import annotations

import pytest

from portbench import spec
from repro_torch.kernels import _build

CELLS = ["deepsets32.trigger", "jscm.trigger"]


def _read():
    return spec.reader("plan_hit_share").read(None)


@pytest.fixture
def counters(monkeypatch):
    plans, launches = _build.LaunchCounts(), _build.LaunchCounts()
    monkeypatch.setattr(_build, "plans", plans)
    monkeypatch.setattr(_build, "launches", launches)
    return plans, launches


def test_reads_none_from_a_program_without_the_counter(monkeypatch):
    monkeypatch.delattr(_build, "plans")
    assert _read() is None


def test_reads_none_without_a_launch(counters):
    plans, launches = counters
    assert _read() is None
    plans.add("deepsets")
    launches.add("mm_int8")             # no plan of its own
    assert _read() is None


@pytest.mark.parametrize("built,launched,want", [
    ({"cascade_mlp": 1}, {"cascade_mlp": 1000}, 99.9),
    ({"cascade_mlp": 2, "deepsets": 1}, {"deepsets": 300, "mm_int8": 50},
     99.0),
    ({"deepsets": 4}, {"deepsets": 4}, 0.0)])
def test_reads_the_share_of_launches_that_found_a_plan(counters, built,
                                                       launched, want):
    plans, launches = counters
    for name, n in built.items():
        for _ in range(n):
            plans.add(name)
    for name, n in launched.items():
        for _ in range(n):
            launches.add(name)
    assert _read() == pytest.approx(want)


@pytest.mark.parametrize("cell", CELLS)
def test_both_cells_report_it(cell):
    (m,) = [m for m in spec.per_layer(spec.benchmark(), cell)
            if m["name"] == "plan_hit_share"]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "%", "higher", "program_counter", "latency_p95_us")
    assert m["layer"] == "kernel wrappers (kernels/cascade_mlp/ops.py)"
