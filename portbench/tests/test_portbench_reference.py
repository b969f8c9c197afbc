"""The plain reference against the port's CPU path, and the yardstick's
counts. Run with ``python -m pytest portbench/tests -q`` from the root."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.reference import deepsets, int8, jets, mlp

CONFIGS = ["deepsets-32", "jsc-m"]


def _setup(name, seed, n):
    """The cell's own set-up, on the CPU: the seeded model and one batch of
    ``n`` events."""
    cfg = spec.config(name)
    ref = spec.reference(cfg["kind"])
    cfg = {**cfg, "ptq": {**cfg["ptq"], "calibration_events": 256}}
    model, pool = ref.make_inputs(cfg, {"batch_events": n, "pool_batches": 1},
                                  seed, torch.device("cpu"))
    return cfg, ref, model, pool[0]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17])
def test_reference_equals_the_ports_cpu_path(name, seed):
    cfg, ref, model, x = _setup(name, seed, 48)
    fn = spec.port(cfg["kind"]).build(cfg, model)
    got = fn(x)
    want = ref.forward(cfg, model, x)
    assert got.dtype == want.dtype == torch.int8
    assert torch.equal(got, want)
    # The scores are not degenerate: the comparison has something to see.
    assert want.float().std() > 2


def test_reference_blocks_agree_with_one_block(monkeypatch):
    cfg, ref, model, x = _setup("deepsets-32", 3, 40)
    whole = ref.forward(cfg, model, x)
    monkeypatch.setattr(deepsets, "BLOCK_EVENTS", 7)
    assert torch.equal(ref.forward(cfg, model, x), whole)
    cfg, ref, model, x = _setup("jsc-m", 3, 8)
    whole = ref.forward(cfg, model, x)
    monkeypatch.setattr(mlp, "BLOCK_ROWS", 100)
    assert torch.equal(ref.forward(cfg, model, x), whole)


@pytest.mark.parametrize("name,ops,nbytes", [("deepsets-32", 177_792, 682),
                                             ("jsc-m", 675_840, 1344)])
def test_operations_and_bytes_per_event(name, ops, nbytes):
    cfg = spec.config(name)
    ref = spec.reference(cfg["kind"])
    assert ref.ops_per_event(cfg) == ops
    assert ref.bytes_per_event(cfg) == nbytes


def test_weight_bytes():
    assert deepsets.weight_bytes(spec.config("deepsets-32")) == 4616
    assert mlp.weight_bytes(spec.config("jsc-m")) == 5280 + 4 * 165


def test_requantize_rounds_half_away_and_saturates():
    acc = torch.tensor([5, 6, -5, -6, 7, -7, 10_000, -10_000, 2 ** 31 - 1],
                       dtype=torch.int32)
    got = int8.requantize(acc, 2).tolist()
    # 1.25 -> 1, 1.5 -> 2, -1.25 -> -1, -1.5 -> -2, 1.75 -> 2, -1.75 -> -2
    assert got[:6] == [1, 2, -1, -2, 2, -2]
    assert got[6:8] == [127, -128]
    assert got[8] == -128   # the add wraps in int32, as the kernels' does


def test_product_wraps_to_int32():
    x = torch.full((1, 2), 127, dtype=torch.int32) * 2 ** 12
    w = torch.full((2, 1), 127, dtype=torch.int32) * 2 ** 12
    want = np.int64(2 * (127 * 2 ** 12) ** 2)
    wrapped = int(((want + 2 ** 31) % 2 ** 32) - 2 ** 31)
    assert int8.product(x, w).item() == wrapped


def test_the_4_bit_grid():
    q = torch.arange(-128, 128, dtype=torch.int32)
    assert torch.equal(int8.on_grid(q, 8), q)
    g = int8.on_grid(q, 4)
    assert set(g.unique().tolist()) <= {16 * k for k in range(-8, 8)}
    assert (g - q).abs().max() <= 16


@pytest.mark.parametrize("name", CONFIGS)
def test_the_control_differs_from_the_reference(name):
    cfg, ref, model, x = _setup(name, 5, 32)
    low = ref.forward(cfg, model, x, bits=4)
    share = (low != ref.forward(cfg, model, x)).float().mean().item()
    assert share > 0.5


def test_the_same_seed_gives_the_same_inputs():
    a = _setup("jsc-m", 2 ** 31 + 5, 4)
    b = _setup("jsc-m", 2 ** 31 + 5, 4)
    c = _setup("jsc-m", 2 ** 31 + 6, 4)
    assert torch.equal(a[3], b[3]) and not torch.equal(a[3], c[3])
    for la, lb in zip(a[2]["stages"]["mlp"], b[2]["stages"]["mlp"]):
        assert torch.equal(la.w, lb.w) and torch.equal(la.b, lb.b)
        assert la.shift == lb.shift


@pytest.mark.parametrize("name", CONFIGS)
def test_the_pool_is_drawn_in_chunks_into_batches(name, monkeypatch):
    monkeypatch.setattr(jets, "CHUNK_EVENTS", 5)
    cfg = spec.config(name)
    cfg = {**cfg, "ptq": {**cfg["ptq"], "calibration_events": 64}}
    ref = spec.reference(cfg["kind"])
    _, pool = ref.make_inputs(cfg, {"batch_events": 6, "pool_batches": 3},
                              7, torch.device("cpu"))
    assert len(pool) == 3
    assert {ref.events_in(cfg, x) for x in pool} == {6}
    assert all(x.dtype == torch.int8 and x.is_contiguous() for x in pool)
    assert not torch.equal(pool[0], pool[1])
