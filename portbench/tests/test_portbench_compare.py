"""The comparison that decides ``correct`` (``compare.py``), on samples built
by hand: exact for the configurations that state no rule, as before the
rule existed, and within a stated tolerance for those that state one; the
checks of a ``"compare"`` block; the peaks by precision; TF32 off around the
reference alone; and the control a kind brings of its own."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

from portbench import compare, control, roofline, run, spec, window

RULE = {"atol": 0.01, "rtol": 0.1, "max_relative_rms": 0.05,
        "why": "a hand-built rule"}
H100 = "NVIDIA H100 80GB HBM3"


class _Ref:
    """A reference that doubles its input, recording the TF32 flags it ran
    under."""

    def __init__(self):
        self.flags = []

    def forward(self, cfg, model, x):
        self.flags.append((torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32))
        return 2 * x


def _sample(pool, outs):
    s = window.Sample(len(outs), 0)
    for i, (p, out) in enumerate(outs):
        s.offer(i, p, out)
    return s


def _parents_checks(ref, cfg, model, pool, sample):
    """The comparison as it stood before configurations stated a rule."""
    differ = compared = 0
    for p, out in sample.kept:
        want = ref.forward(cfg, model, pool[p])
        differ += int((out != want).sum())
        compared += want.numel()
    return {"mismatched_scores": {"value": differ, "limit": 0,
                                  "holds_if": "value <= limit"},
            "scores_compared": {"value": compared, "limit": 1,
                                "holds_if": "value >= limit"}}


def _int8_sample():
    pool = [torch.arange(-6, 6, dtype=torch.int8).reshape(3, 4),
            torch.ones(2, 5, dtype=torch.int8)]
    good0, good1 = 2 * pool[0], 2 * pool[1]
    bad0 = good0.clone()
    bad0[1, 2] += 1
    bad0[2, 0] -= 3
    bad1 = good1.clone()
    bad1[0, 4] = 0
    return pool, [(0, good0), (1, bad1), (0, bad0), (1, good1)]


@pytest.mark.parametrize("which", ["all equal", "three differ"])
def test_exact_checks_are_the_parents(which):
    pool, outs = _int8_sample()
    if which == "all equal":
        outs = [(p, 2 * pool[p]) for p, _ in outs]
    sample = _sample(pool, outs)
    cfg = spec.config("deepsets-32")
    assert "compare" not in cfg
    want = _parents_checks(_Ref(), cfg, None, pool, sample)
    got = run.check(_Ref(), cfg, None, pool, sample)
    assert got == want
    assert list(got) == ["mismatched_scores", "scores_compared"]
    assert got["scores_compared"]["value"] == 2 * 12 + 2 * 10
    assert got["mismatched_scores"]["value"] == (0 if which == "all equal"
                                                 else 3)
    assert compare.correct(got) is (which == "all equal")


def test_exact_with_nothing_compared_is_not_correct():
    found = compare.checks([])
    assert found["scores_compared"]["value"] == 0
    assert not compare.correct(found)


def _float_pair(n=1000, seed=0):
    g = torch.Generator().manual_seed(seed)
    want = torch.randn(n, generator=g, dtype=torch.float64).float()
    return want.clone(), want


def test_within_tolerance_is_correct():
    out, want = _float_pair()
    out = out * (1 + 0.02) + 0.005          # every score within 0.01 + 0.1|w|
    found = compare.checks([(out, want), (want.clone(), want)], RULE)
    assert list(found) == ["scores_outside_tolerance", "relative_rms_error",
                           "scores_compared"]
    assert found["scores_outside_tolerance"]["value"] == 0
    assert found["scores_compared"]["value"] == 2000
    assert 0 < found["relative_rms_error"]["value"] < 0.05
    assert found["relative_rms_error"]["limit"] == 0.05
    assert compare.correct(found)


def test_the_tolerance_bound_itself_is_within():
    rule = dict(RULE, atol=0.125, rtol=0.25, max_relative_rms=1)
    want = torch.tensor([0.0, 2.0, -4.0])
    out = torch.tensor([0.125, 2.625, -5.125])    # exactly atol + rtol|want|
    found = compare.checks([(out, want)], rule)
    assert found["scores_outside_tolerance"]["value"] == 0
    found = compare.checks([(out + torch.tensor([0, 1e-6, 0]), want)], rule)
    assert found["scores_outside_tolerance"]["value"] == 1


@pytest.mark.parametrize("bad", [
    "past atol + rtol|want|", "nan", "inf", "-inf", "inf in want"])
def test_one_score_outside_is_not_correct(bad):
    out, want = _float_pair()
    i = 17
    if bad == "past atol + rtol|want|":
        out[i] = want[i] + 1.001 * (0.01 + 0.1 * abs(float(want[i])))
    elif bad == "inf in want":
        want = want.clone()
        want[i] = out[i] = math.inf
    else:
        out[i] = float(bad)
    found = compare.checks([(out, want)], RULE)
    assert found["scores_outside_tolerance"]["value"] == 1
    assert not compare.correct(found)


def test_a_nonfinite_rms_reads_null_and_fails():
    out, want = _float_pair()
    out[3] = math.nan
    found = compare.checks([(out, want)], RULE)
    assert found["relative_rms_error"]["value"] is None
    assert not compare.holds(found["relative_rms_error"])


def test_an_rms_over_its_limit_fails_with_every_score_within():
    out, want = _float_pair()
    out = out * 1.08                        # 8% everywhere: within rtol 10%
    found = compare.checks([(out, want)], RULE)
    assert found["scores_outside_tolerance"]["value"] == 0
    assert found["relative_rms_error"]["value"] == pytest.approx(0.08)
    assert not compare.correct(found)


def test_a_zero_reference_reads_zero_only_where_equal():
    z = torch.zeros(4)
    assert compare.checks([(z, z)], RULE)["relative_rms_error"]["value"] == 0
    found = compare.checks([(z + 1e-3, z)], RULE)
    assert found["scores_outside_tolerance"]["value"] == 0
    assert found["relative_rms_error"]["value"] is None


@pytest.mark.parametrize("block", [
    {"rtol": 0.1, "max_relative_rms": 0.05, "why": "no atol"},
    {"atol": 0.01, "max_relative_rms": 0.05, "why": "no rtol"},
    {"atol": 0.01, "rtol": 0.1, "why": "no rms"},
    {"atol": -0.01, "rtol": 0.1, "max_relative_rms": 0.05, "why": "neg"},
    {"atol": 0.01, "rtol": -1, "max_relative_rms": 0.05, "why": "neg"},
    {"atol": 0.01, "rtol": 0.1, "max_relative_rms": -0.05, "why": "neg"},
    {"atol": "0.01", "rtol": 0.1, "max_relative_rms": 0.05, "why": "str"},
    {"atol": True, "rtol": 0.1, "max_relative_rms": 0.05, "why": "bool"},
    {"atol": math.nan, "rtol": 0.1, "max_relative_rms": 0.05, "why": "nan"},
    {"atol": 0.01, "rtol": 0.1, "max_relative_rms": math.inf, "why": "i"},
    {"atol": 0.01, "rtol": 0.1, "max_relative_rms": 0.05},
    {"atol": 0.01, "rtol": 0.1, "max_relative_rms": 0.05, "why": " "},
    {"atol": 0.01, "rtol": 0.1, "max_relative_rms": 0.05, "why": 3},
    dict(RULE, rms=0.05),
    [0.01, 0.1, 0.05],
], ids=lambda b: repr(b)[:48])
def test_spec_refuses_a_bad_compare_block(block):
    with pytest.raises(ValueError):
        spec.check_config({"name": "x", "kind": "mlp", "compare": block})


def test_spec_takes_a_good_compare_block():
    cfg = {"name": "x", "kind": "mlp", "compare": dict(RULE, atol=0)}
    assert spec.check_config(cfg) is cfg


@pytest.mark.parametrize("name", ["deepsets-32", "jsc-m"])
def test_the_int8_configurations_state_neither_key(name):
    cfg = spec.config(name)
    assert "compare" not in cfg and "peak" not in cfg


def test_peaks_by_precision():
    assert roofline.peaks(H100, "int8") == (1979e12, 3.35e12)
    assert roofline.peaks(H100, "bf16") == (989.4e12, 3.35e12)
    for precision, ops in roofline.PEAKS[H100]["ops"].items():
        assert ops > 0, precision
    with pytest.raises(ValueError):
        roofline.peaks(H100, "int3")
    with pytest.raises(ValueError):
        roofline.peaks("NVIDIA A100-SXM4-80GB", "int8")


def _run(precision):
    cfg = spec.config("deepsets-32")
    w = window.Window(seconds=2.0, issued=100, done=98)
    return run.Run(config=cfg, traffic={}, ref=spec.reference("deepsets"),
                   batch_events=1000, peak=roofline.peaks(H100, precision),
                   window=w)


def test_mfu_reads_the_parents_value_on_an_int8_run_and_follows_the_peak():
    mfu = spec.reader("mfu")
    parents = 100 * 98 * 1000 * 177_792 / (2.0 * 1979e12)
    assert mfu.read(_run("int8")) == parents
    assert mfu.read(_run("bf16")) == pytest.approx(parents * 1979 / 989.4)


@pytest.mark.parametrize("before", [True, False])
def test_tf32_is_off_inside_the_comparison_and_restored_after(
        before, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not before)
    pool, outs = _int8_sample()
    ref = _Ref()
    run.check(ref, spec.config("jsc-m"), None, pool, _sample(pool, outs))
    assert ref.flags and set(ref.flags) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 is before
    assert torch.backends.cudnn.allow_tf32 is (not before)


def test_tf32_is_restored_after_a_comparison_that_raises(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)

    class Raising(_Ref):
        def forward(self, cfg, model, x):
            raise RuntimeError("reference failed")
    pool, outs = _int8_sample()
    with pytest.raises(RuntimeError):
        run.check(Raising(), spec.config("jsc-m"), None, pool,
                  _sample(pool, outs))
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True


def test_the_control_is_the_kinds_own_where_it_has_one(monkeypatch):
    calls = []

    def forward(cfg, model, x, bits=8):
        calls.append(bits)
        return x
    four_bit = SimpleNamespace(forward=forward)
    own = SimpleNamespace(forward=forward,
                          lower_precision=lambda cfg, model: "own")
    monkeypatch.setattr(spec, "reference",
                        lambda kind: {"a": four_bit, "b": own}[kind])
    fn = control.lower_precision({"kind": "a"}, None)
    fn(torch.zeros(1))
    assert calls == [4]
    assert control.lower_precision({"kind": "b"}, None) == "own"
