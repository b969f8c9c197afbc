"""The benchmark on the card: a short run of each cell through the command,
traced and not; and, at each cell's own size, the faults under the timed
path and the lower-precision control, which ``correct`` must reject.
Marked ``cuda``; each skips, from a fixture, where there is no CUDA
device."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run, spec

ROOT = Path(spec.__file__).resolve().parents[1]
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _command(cell, seed, trace):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", str(seed), "--seconds", "1",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    r = _command(cell, 2 ** 31 - 7, 0)
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end(
        BENCH, cell)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_on_the_card(card, cell):
    r = _command(cell, 2 ** 31 - 9, 1)
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["metrics"]) == {m["name"] for m in spec.per_layer(
        BENCH, cell)}
    assert r["breakdown"]["device_ops"]


def _half_batch(fn):
    def f(x):
        out = fn(x)
        out[out.shape[0] // 2:] = 0
        return out
    return f


def _one_answer_altered(fn):
    def f(x):
        out = fn(x).clone()
        out.view(-1)[0] += 1
        return out
    return f


def _stale(fn):
    """The first call's output returned again: state left unchanged."""
    first = []

    def f(x):
        if not first:
            first.append(fn(x))
        return first[0]
    return f


def _half_the_set(fn):
    """DeepSets' aggregation over half the particles."""
    def f(x):
        x = x.clone()
        x[:, x.shape[1] // 2:] = 0
        return fn(x)
    return f


FAULTS = [(c, f) for c in CELLS for f in (_half_batch, _one_answer_altered,
                                          _stale)]
FAULTS += [(c, _half_the_set) for c in CELLS
           if spec.config(spec.cell(BENCH, c)["config"])["kind"]
           == "deepsets"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_under_the_timed_path_is_not_correct(card, cell, fault):
    r = run.run_cell(cell, 2 ** 31 + 3, 1.0, False, wrap=fault)
    assert r["correct"] is False
    assert r["checks"]["mismatched_scores"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card_is_not_correct(card, cell):
    from portbench.control import lower_precision
    r = run.run_cell(cell, 2 ** 31 + 11, 1.0, False, forward=lower_precision)
    assert r["correct"] is False
    assert r["checks"]["mismatched_scores"]["value"] > 0
