"""A float kind (``float_mlp.py`` beside this file, absent from
BENCHMARK.json) through the harness's comparison: on the CPU its bf16
stand-in port passes the tolerance its configuration states and its e4m3
control fails it; on the card (marked ``cuda``) the same holds through
``run.run_cell``, with ``spec`` pointed at the kind."""
from __future__ import annotations

import pytest
import torch

from portbench import compare, control, roofline, run, spec, window
from portbench.tests import float_mlp

CELL = "floatmlp.trigger"
SMALL = {"batch_events": 200, "pool_batches": 3}


def point_spec_at_the_float_kind(monkeypatch):
    """``spec`` as if BENCHMARK.json held the kind and a cell of it on the
    trigger loop's Allen slices."""
    bench = spec.benchmark()
    bench["configs"] = bench["configs"] + [{
        "name": float_mlp.CONFIG["name"], "source": "portbench/tests",
        "file": "portbench/tests/float_mlp.py", "reduced": [],
        "why": "a float kind for the tests"}]
    bench["workloads"] = bench["workloads"] + [{
        "name": CELL, "config": float_mlp.CONFIG["name"],
        "traffic": "trigger.s1000", "chips": 1,
        "why": "a float kind for the tests"}]
    config, reference, port = spec.config, spec.reference, spec.port
    monkeypatch.setattr(spec, "benchmark", lambda: bench)
    monkeypatch.setattr(spec, "config", lambda name: (
        spec.check_config(dict(float_mlp.CONFIG))
        if name == float_mlp.CONFIG["name"] else config(name)))
    monkeypatch.setattr(spec, "reference", lambda kind: (
        float_mlp if kind == "float_mlp" else reference(kind)))
    monkeypatch.setattr(spec, "port", lambda kind: (
        float_mlp if kind == "float_mlp" else port(kind)))


def _checks(fn_of, seed):
    cfg = float_mlp.CONFIG
    model, pool = float_mlp.make_inputs(cfg, SMALL, seed, "cpu")
    fn = fn_of(cfg, model)
    sample = window.Sample(len(pool), seed)
    for i, x in enumerate(pool):
        sample.offer(i, i, fn(x))
    return run.check(float_mlp, cfg, model, pool, sample)


def test_the_float_kind_states_a_rule_and_a_peak():
    cfg = spec.check_config(dict(float_mlp.CONFIG))
    assert roofline.peaks("NVIDIA H100 80GB HBM3", cfg["peak"])[0] == 989.4e12
    assert float_mlp.ops_per_event(cfg) == 16 * 2 * (
        64 * 256 + 256 * 256 + 256 * 16)


@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102])
def test_on_the_cpu_the_port_passes_and_the_control_fails(seed):
    port = _checks(float_mlp.build, seed)
    assert compare.correct(port), port
    low = _checks(float_mlp.lower_precision, seed)
    assert not compare.correct(low), low
    assert low["scores_outside_tolerance"]["value"] > 0
    assert (low["relative_rms_error"]["value"]
            > low["relative_rms_error"]["limit"])


def test_the_control_module_takes_the_kinds_own(monkeypatch):
    point_spec_at_the_float_kind(monkeypatch)
    cfg = spec.config(float_mlp.CONFIG["name"])
    model, pool = float_mlp.make_inputs(cfg, SMALL, 5, "cpu")
    got = control.lower_precision(cfg, model)(pool[0])
    want = float_mlp.lower_precision(cfg, model)(pool[0])
    assert torch.equal(got, want)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_on_the_card_the_port_is_correct_through_run_cell(card, monkeypatch):
    point_spec_at_the_float_kind(monkeypatch)
    r = run.run_cell(CELL, 2 ** 31 + 201, 1.0, False)
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == ["scores_outside_tolerance",
                                 "relative_rms_error", "scores_compared"]
    assert set(r["metrics"]) == {"events_per_s", "mfu", "setup_s"}


@pytest.mark.cuda
def test_on_the_card_the_e4m3_control_is_not_correct(card, monkeypatch):
    point_spec_at_the_float_kind(monkeypatch)
    r = run.run_cell(CELL, 2 ** 31 + 202, 1.0, False,
                     forward=control.lower_precision)
    assert r["correct"] is False
    assert r["checks"]["scores_outside_tolerance"]["value"] > 0
