"""The LM path's spans and counters (``repro_torch.kernels._build.spans``) on
the CPU, on reduced DeepSeek-V2: ``repro_torch.prefill`` (a call of
``steps.make_prefill``), ``repro_torch.mla`` (one an MLA layer),
``repro_torch.moe.route``, ``repro_torch.moe.sync`` and
``repro_torch.moe.experts`` (one each a MoE layer, in turn), and the MoE's
counters (the host's waits on the device, counted by ``_build.host_syncs``;
whether the grouped kernel K6 ran; the rows its held experts got, their
largest over their mean, read from the device only when the counters are). On the CPU
nothing waits on a device, so the sync counter reads 0 there; the
``cuda``-marked tests read it on the card.

With no profiler recording, each of those sites queries the profiler's
state once and does nothing else for tracing, as the K2/K3 wrappers'
(``test_torch_spans.py``)."""
from __future__ import annotations

import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import configs
from repro_torch.distributed.steps import make_prefill
from repro_torch.kernels import _build
from repro_torch.models import build
from repro_torch.models import moe as M

CALLER = "caller.call"
LM_SPANS = ("repro_torch.prefill", "repro_torch.mla",
            "repro_torch.moe.route", "repro_torch.moe.sync",
            "repro_torch.moe.experts")
MOE_PHASES = LM_SPANS[2:]
COUNTERS = ("repro_torch.moe.syncs", "repro_torch.moe.grouped",
            "repro_torch.moe.rows", "repro_torch.moe.load_max_over_mean")


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


def _prefill(device="cpu"):
    cfg = configs.get_reduced("deepseek-v2-lite")
    model = build(cfg, device=device, seed=2)
    tokens = torch.randint(0, cfg.vocab, (1, 24),
                           generator=torch.Generator().manual_seed(4))
    step = make_prefill(cfg, device=device, last_only=True)
    return cfg, lambda: step(model, {"tokens": tokens})


def test_a_prefill_without_a_profiler_records_nothing(monkeypatch):
    cfg, call = _prefill()
    query = _Counting(False)
    clock, rng, lock = _Counting(0), _Counting(), _Counting()
    monkeypatch.setattr(_build, "recording", query)
    monkeypatch.setattr(_build, "_clock", clock)
    monkeypatch.setattr(_build, "_Range", rng)
    monkeypatch.setattr(_build.spans, "_lock", lock)
    before = _build.spans.totals(), _build.spans.counts()
    lock.n = 0
    for _ in range(3):
        call()
    # one query a site: the prefill, each MLA layer, each MoE layer
    assert query.n == 3 * (1 + cfg.n_layers + cfg.n_groups)
    assert clock.n == rng.n == lock.n == 0
    assert (_build.spans.totals(), _build.spans.counts()) == before


def _profiled(call, log, activities=(ProfilerActivity.CPU,)):
    """(the profiler, a fresh recorder) of one call under a profiler."""
    rec = _build.HotSpans()
    old = _build.spans
    try:
        # the modules hold the recorder by name: point each at a fresh one
        import repro_torch.distributed.steps as steps
        import repro_torch.models.attention as attention
        for mod in (steps, attention, M):
            mod.spans = rec
        with profile(activities=list(activities)) as prof:
            with record_function(CALLER), M.routing_log(log):
                call()
    finally:
        for mod in (steps, attention, M):
            mod.spans = old
    return prof, rec


def test_a_profiled_prefill_nests_its_spans_and_counts_its_moe():
    cfg, call = _prefill()
    log = []
    prof, rec = _profiled(call, log)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == CALLER or e.name() in LM_SPANS]
    by = {}
    for e in ev:
        by.setdefault(e.name(), []).append(e)
    assert {k: len(v) for k, v in by.items()} == {
        CALLER: 1, "repro_torch.prefill": 1, "repro_torch.mla": cfg.n_layers,
        **{k: cfg.n_groups for k in MOE_PHASES}}
    outer, pre = by[CALLER][0], by["repro_torch.prefill"][0]
    assert outer.start_ns() <= pre.start_ns() <= pre.end_ns() \
        <= outer.end_ns()
    for name in LM_SPANS[1:]:
        for e in by[name]:
            assert pre.start_ns() <= e.start_ns() <= e.end_ns() \
                <= pre.end_ns()
    # each layer's phases in turn: route, the wait, the experts
    for r, w, x in zip(*(by[k] for k in MOE_PHASES)):
        assert r.end_ns() <= w.start_ns() <= w.end_ns() <= x.start_ns()
    tot = rec.totals()
    assert {k: n for k, (n, _) in tot.items()} == {
        "repro_torch.prefill": 1, "repro_torch.mla": cfg.n_layers,
        **{k: cfg.n_groups for k in MOE_PHASES}}
    # the counters: no wait on a device (the CPU has none), the rows the
    # held experts got
    first, n = cfg.experts_held
    rows = [((r.expert_ids >= first) & (r.expert_ids < first + n)).sum()
            for r in log]
    ratios = []
    for r in log:
        per = [int((r.expert_ids == first + j).sum()) for j in range(n)]
        ratios.append(max(per) * n / sum(per))
    counts = rec.counts()
    assert set(counts) == set(COUNTERS)
    assert counts["repro_torch.moe.syncs"] == (cfg.n_groups, 0)
    # CPU tensors take the loop, not K6
    assert counts["repro_torch.moe.grouped"] == (cfg.n_groups, 0)
    assert counts["repro_torch.moe.rows"] == (cfg.n_groups,
                                              int(sum(rows)))
    n_ratio, total = counts["repro_torch.moe.load_max_over_mean"]
    assert n_ratio == cfg.n_groups
    assert total == pytest.approx(sum(ratios))


def test_counters_add_values_by_name():
    rec = _build.HotSpans()
    rec.count("a")
    rec.count("a", 4)
    rec.count("b", 0.5)
    assert rec.counts() == {"a": (2, 5), "b": (1, 0.5)}
    assert rec.totals() == {}


def test_host_syncs_counts_the_sync_warnings_and_restores_the_mode(
        monkeypatch):
    """Stands in for the card: the sync debug mode's setter and getter, and
    the warnings it would raise; other warnings pass through."""
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with _build.host_syncs(torch.device("cuda")) as n:
            assert modes[-1] == "warn"
            for _ in range(3):
                warnings.warn(_build.SYNC_WARNING)
            warnings.warn("something else")
        assert n == [3]
    assert modes[-1] == "default"
    assert [str(w.message) for w in shown] == ["something else"]
    with _build.host_syncs(torch.device("cpu")) as n:
        torch.ones(3).sum().item()
    assert n == [0] and modes[-1] == "default"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_host_syncs_counts_each_wait_on_the_card(card):
    x = torch.arange(12, device="cuda")
    before = torch.cuda.get_sync_debug_mode()
    with _build.host_syncs(x.device) as n:
        x.sum().item()
        x[:3].tolist()
        y = x * 2                     # no wait
    assert n == [2]
    with _build.host_syncs(x.device) as n:
        torch.bincount(y)            # sizes its output from the max
    assert n[0] >= 1
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.cuda
def test_a_profiled_prefill_on_the_card_counts_one_sync_a_moe_layer(card):
    cfg, call = _prefill("cuda")
    call()
    prof, rec = _profiled(call, [], (ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA))
    assert rec.counts()["repro_torch.moe.syncs"] == (cfg.n_groups,
                                                     cfg.n_groups)
