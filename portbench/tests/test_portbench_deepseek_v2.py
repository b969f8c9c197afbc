"""The ``deepseek_v2`` kind (configuration ``deepseek-v2-lite``, cell
``dsv2lite.prefill16k``): its file as ``spec`` reads it, the port's adapter
against the reference within the file's ``"compare"`` rule and the e4m3
control outside it (on the CPU at a small size of the same structure), the
operation and byte counts by hand, the seeded prompts, and the readers of
the cell's per-layer metrics, which read None where a run has nothing to
read. Marked ``cuda``: the cell at its own size through ``run.run_cell``,
traced and not."""
from __future__ import annotations

import pytest
import torch

from portbench import compare, program_spans, roofline, run, spec, window
from portbench.port import deepseek_v2 as port
from portbench.reference import deepseek_v2 as ref

CELL = "dsv2lite.prefill16k"
NEW_METRICS = ["k5_mla_roofline", "moe_route_us", "moe_syncs_per_call",
               "moe_load_max_over_mean", "idle_share.prefill"]


def small(cfg=None):
    """The configuration's structure at a CPU-test size: 3 layers (1
    dense), d 64, 4 heads, MLA 16 + 8 rope, 2 of 16 experts held, a
    vocabulary of 256, prompts of 64 tokens."""
    cfg = cfg or spec.config("deepseek-v2-lite")
    return dict(cfg, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=4, kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=8, v_head_dim=8, intermediate_size=128,
                moe_intermediate_size=32, num_hidden_layers=3,
                experts_routed_over=16, n_routed_experts=2, vocab_size=256,
                prompt_tokens=64)


def small_traffic():
    return dict(spec.traffic("prefill.s16k"), prompt_tokens=64,
                pool_batches=3)


def test_spec_accepts_the_file_and_it_states_the_cut():
    cfg = spec.config("deepseek-v2-lite")
    assert cfg["kind"] == "deepseek_v2" and cfg["peak"] == "bf16"
    assert compare.check_rule(cfg["compare"]) is cfg["compare"]
    assert roofline.peaks("NVIDIA H100 80GB HBM3", cfg["peak"])[0] == 989.4e12
    bench = spec.benchmark()
    entry = next(c for c in bench["configs"]
                 if c["name"] == "deepseek-v2-lite")
    assert entry["reduced"] == cfg["reduced"] == ["n_routed_experts",
                                                  "vocab_size"]
    assert (cfg["n_routed_experts"], cfg["n_routed_experts_published"],
            cfg["experts_routed_over"]) == (8, 64, 64)
    assert (cfg["vocab_size"], cfg["vocab_size_published"],
            cfg["chips_sharing_each_layer"]) == (12_800, 102_400, 8)
    assert spec.traffic("prefill.s16k")["prompt_tokens"] \
        == cfg["prompt_tokens"] == 16_384
    assert spec.cell(bench, CELL)["chips"] == 1


def test_the_files_sizes_are_the_ports_registry():
    from repro_torch import configs
    assert port.arch(spec.config("deepseek-v2-lite")) == configs.get(
        "deepseek-v2-lite")


def _checks(fn_of, cfg, seed, traffic=None):
    model, pool = ref.make_inputs(cfg, traffic or small_traffic(), seed,
                                  "cpu")
    fn = fn_of(cfg, model)
    sample = window.Sample(len(pool), seed)
    for i, x in enumerate(pool):
        sample.offer(i, i, fn(x))
    return run.check(ref, cfg, model, pool, sample)


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 2 ** 32 + 5])
def test_on_the_cpu_the_port_passes_and_the_control_fails(seed):
    """At 64-token prompts and 3 layers the port reads a relative RMS of
    0.007-0.009 and the e4m3 control 0.089-0.136 (six seeds), on both
    sides of the card's limit of 0.08, as on the card (§2 of PERF.md)."""
    got = _checks(port.build, small(), seed)
    assert compare.correct(got), got
    assert got["scores_compared"]["value"] == 3 * 256
    low = _checks(ref.lower_precision, small(), seed)
    assert not compare.correct(low), low
    assert (low["relative_rms_error"]["value"]
            > low["relative_rms_error"]["limit"])


def test_the_seed_gives_the_inputs_and_the_prompts_are_zipf():
    cfg, tr = small(), dict(small_traffic(), prompt_tokens=64 * 64)
    cfg["prompt_tokens"] = tr["prompt_tokens"]
    a_model, a = ref.make_inputs(cfg, tr, 9, "cpu")
    b_model, b = ref.make_inputs(cfg, tr, 9, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a_model["lm_head"], b_model["lm_head"])
    _, c = ref.make_inputs(cfg, tr, 10, "cpu")
    assert not torch.equal(a[0], c[0])
    ids = torch.cat(a).reshape(-1)
    assert a[0].shape == (1, tr["prompt_tokens"]) and a[0].dtype == torch.long
    assert 0 <= int(ids.min()) and int(ids.max()) < cfg["vocab_size"]
    # rank 1 of a Zipf(1) law over 256 ids: 1 / H_256 = 0.163 of the draws
    top = torch.bincount(ids, minlength=256).max() / ids.numel()
    assert 0.14 < float(top) < 0.19
    with pytest.raises(ValueError, match="prompts"):
        ref.make_inputs(cfg, dict(tr, prompt_tokens=32), 9, "cpu")


def test_the_counts_by_hand_at_a_small_size():
    cfg = small()
    S, d, H, V = 64, 64, 4, 256
    mla = d * H * 16 + d * (16 + 8) + 16 * H * 16 + H * 8 * d
    dense = 3 * d * 128
    expert = 3 * d * 32
    moe = d * 16 + 2 * expert + expert * 6 * 2 / 16
    k5 = 2 * H * (16 + 8) * S * (S + 1) // 2
    assert ref.k5_launch_ops(cfg) == k5
    assert ref.k5_launch_bytes(cfg) == 2 * S * H * (2 * 16 + 2 * 8)
    assert ref.ops_per_event(cfg) == pytest.approx(
        2 * S * (3 * mla + dense + 2 * moe) + 2 * d * V + 3 * k5)
    assert ref.bytes_per_event(cfg) == 8 * S + 4 * V
    model, _ = ref.make_inputs(cfg, small_traffic(), 1, "cpu")
    assert ref.weight_bytes(cfg) == sum(
        t.numel() * t.element_size() for t in _leaves(model))
    assert ref.events_in(cfg, torch.zeros(1, S)) == 1


def test_the_full_size_counts():
    cfg = spec.config("deepseek-v2-lite")
    assert ref.ops_per_event(cfg) == pytest.approx(71.870005e12, rel=1e-7)
    assert 27 * ref.k5_launch_ops(cfg) / ref.ops_per_event(cfg) \
        == pytest.approx(0.516, abs=1e-3)
    # 2.744 B parameters: 5.49 GB in bf16, the router and norms in f32
    assert ref.weight_bytes(cfg) == pytest.approx(5.495e9, rel=1e-3)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _read(name, r):
    return spec.reader(name).read(r)


def _run(trace=None):
    cfg = spec.config("deepseek-v2-lite")
    return run.Run(config=cfg, traffic=spec.traffic("prefill.s16k"), ref=ref,
                   batch_events=1, peak=(989.4e12, 3.35e12), trace=trace)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_the_readers_read_none_where_there_is_nothing(name, monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "spans", _build.HotSpans())
    import repro_torch.obs.tracing as tracing
    monkeypatch.setattr(tracing, "spans", _build.spans)
    assert _read(name, _run()) is None
    # a program without the recorder (or, for the counters, without
    # counters: the parent of this configuration)
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert _read(name, _run()) is None
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: type("Old", (), {"totals": dict,
                                                 "mean_us": lambda s, n:
                                                 None})())
    assert _read(name, _run({"busy_s": 0.0, "window_s": 0.0,
                             "kernels": {}})) is None


def test_the_readers_read_a_traced_run(monkeypatch):
    from repro_torch.kernels import _build
    rec = _build.HotSpans()
    monkeypatch.setattr(program_spans, "recorder", lambda: rec)
    rec.add_all([("repro_torch.prefill", 1000)] * 4
                + [("repro_torch.moe.route", 3000),
                   ("repro_torch.moe.route", 5000)])
    # 4 prefills of 26 MoE layers: each layer adds the waits it made, one
    # but in a layer that made 5
    for _ in range(4 * 26 - 1):
        rec.count("repro_torch.moe.syncs", 1)
    rec.count("repro_torch.moe.syncs", 5)
    rec.count("repro_torch.moe.load_max_over_mean", 1.5)
    rec.count("repro_torch.moe.load_max_over_mean", 2.5)
    cfg = spec.config("deepseek-v2-lite")
    launch = 2 * 16 * 320 * 16384 * 16385 // 2
    t = 4e-3
    # the trace's name of the kernel, as devtrace keeps it
    name = ("void (anonymous namespace)::flash_attn_bf16_kernel<256, false>"
            "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
            "__nv_bfloat16*, int, int, int, int, int, float)")
    r = _run({"busy_s": 1.5, "window_s": 2.0,
              "kernels": {name: (27 * 4 * t, 27 * 4),
                          "deepsets_kernel": (1.0, 1)}})
    assert _read("moe_route_us", r) == pytest.approx(4.0)
    assert _read("moe_syncs_per_call", r) == 27
    assert _read("moe_load_max_over_mean", r) == pytest.approx(2.0)
    assert _read("idle_share.prefill", r) == pytest.approx(25.0)
    assert ref.k5_launch_ops(cfg) == launch
    assert _read("k5_mla_roofline", r) == pytest.approx(
        100 * launch / 989.4e12 / t)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_on_the_card_a_short_run_of_the_cell(card):
    r = run.run_cell(CELL, 2 ** 31 + 333, 2.0, False)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"events_per_s", "mfu", "setup_s"}
    t = run.run_cell(CELL, 2 ** 31 + 334, 2.0, True)
    assert t["correct"] is True, t["checks"]
    assert set(t["metrics"]) == set(NEW_METRICS)
    assert 0 < t["metrics"]["k5_mla_roofline"]["value"] <= 100
    assert t["metrics"]["moe_syncs_per_call"]["value"] == 26


@pytest.mark.cuda
def test_on_the_card_the_e4m3_control_is_not_correct(card):
    from portbench.control import lower_precision
    r = run.run_cell(CELL, 2 ** 31 + 335, 1.0, False,
                     forward=lower_precision)
    assert r["correct"] is False, r["checks"]
