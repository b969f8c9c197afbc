"""DeepSeek-V2 on the port's LM path (``configs.deepseek_v2_lite``), against
its plain float32 reference (``_deepseek_v2_ref.py`` beside this file), at
the reduced size on the CPU: the prefill at every position, decoding
through the MLA latent cache, the held share of the experts, dropless and
unrenormalised routing, YaRN, the configuration and its counts.

The port computes in bf16 and the reference in float32, so logits are
compared by their relative RMS error over the positions compared and by
the largest error over the largest logit (``REL_RMS``, ``MAX_REL``: the
prefill reads 0.0082-0.0094 and 0.0086-0.0153 on six seeds, the reference
with e4m3 operands, each scaled into e4m3's range, 0.111-0.126 and
0.144-0.188). The router reads the port's bf16 activations
and the reference's float32 ones, so a near-tie can send a token to
another expert; the model tests pin the port's routing to the
reference's (``moe.routing_log`` with a pick) and check apart that the
two routers agree but for near-ties.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import _deepseek_v2_ref as ref
from repro_torch import configs
from repro_torch.configs import deepseek_v2_lite as dsv2
from repro_torch.distributed.steps import make_prefill
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.transformer import (Transformer, _mla_cfg,
                                            _moe_cfg, tied)

REL_RMS = 0.03
MAX_REL = 0.06
#: a router choice may differ from the reference's only where the two
#: experts' probabilities lie this close (the bf16 router input's rounding)
TIE_MARGIN = 2e-3
SEEDS = [3, 2 ** 31 + 41]
S = 48

#: The reduced configuration in the published keys, as the reference reads
#: it (``configs.deepseek_v2_lite.reduced``'s sizes).
CFG = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "q_lora_rank": None, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
    "qk_rope_head_dim": 8, "v_head_dim": 8, "intermediate_size": 128,
    "moe_intermediate_size": 32, "num_hidden_layers": 3,
    "first_k_dense_replace": 1, "experts_routed_over": 16,
    "experts_held_from": 0, "n_routed_experts": 2, "n_shared_experts": 2,
    "num_experts_per_tok": 6, "norm_topk_prob": False,
    "routed_scaling_factor": 1, "vocab_size": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}


def _swiglu(p):
    return {"wg": p["gate_proj"], "wu": p["up_proj"], "wd": p["down_proj"]}


def port_params(cfg, model) -> dict:
    """The reference's weights in the port's layout (the same tensors)."""
    layers = []
    for i, p in enumerate(model["layers"]):
        a, m = p["self_attn"], p["mlp"]
        block = {"ln1": {"scale": p["input_layernorm"]},
                 "mla": {"wq": {"w": a["q_proj"]},
                         "wkv_a": {"w": a["kv_a_proj_with_mqa"]},
                         "kv_norm": {"scale": a["kv_a_layernorm"]},
                         "wkv_b": {"w": a["kv_b_proj"]},
                         "wo": {"w": a["o_proj"]}},
                 "ln2": {"scale": p["post_attention_layernorm"]}}
        if i < cfg["first_k_dense_replace"]:
            block["mlp"] = _swiglu(m)
        else:
            block["moe"] = {"router": m["gate"], **_swiglu(m["experts"]),
                            "shared": _swiglu(m["shared_experts"])}
        layers.append(block)
    return {"embedding": {"emb": model["embed_tokens"]},
            "final_norm": {"scale": model["norm"]},
            "lm_head": {"w": model["lm_head"]}, "layers": layers}


def _setup(seed, cfg=CFG, arch=None):
    gen = torch.Generator().manual_seed(seed)
    model = ref.make_model(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (S,), generator=gen)
    arch = arch or configs.get_reduced("deepseek-v2-lite")
    return model, tokens, Transformer(arch, port_params(cfg, model))


def _recorded_routing(monkeypatch):
    """The reference's expert ids, one (S, K) tensor a MoE layer, recorded
    as its forward routes."""
    seen = []
    routing = ref.routing

    def record(*a, **kw):
        gates, ids = routing(*a, **kw)
        seen.append(ids)
        return gates, ids
    monkeypatch.setattr(ref, "routing", record)
    return seen


def _errors(out, want):
    return (float((out - want).norm() / want.norm()),
            float((out - want).abs().max() / want.abs().max()))


def test_the_reduced_config_is_the_references():
    a = configs.get_reduced("deepseek-v2-lite")
    assert (a.d_model, a.n_heads, a.d_ff, a.expert_ff, a.n_layers, a.vocab) \
        == (64, 4, 128, 32, 3, 256)
    assert (a.n_experts, a.top_k, a.experts_held, a.n_shared_experts) == (
        CFG["experts_routed_over"], CFG["num_experts_per_tok"],
        (0, CFG["n_routed_experts"]), CFG["n_shared_experts"])
    m = a.mla
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim,
            m.v_head_dim) == (None, 16, 8, 8, 8)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_prefill_agrees_with_the_reference_at_every_position(
        seed, monkeypatch):
    model, tokens, port = _setup(seed)
    seen = _recorded_routing(monkeypatch)
    want = ref.logits(CFG, model, tokens, last=False)
    log = []
    with M.routing_log(log, pick=lambda i: (seen[i][None],
                                            torch.ones_like(seen[i][None],
                                                            dtype=bool))):
        got, _ = port(tokens[None])
    assert len(log) == len(seen) == 2
    rms, mx = _errors(got[0], want)
    assert rms <= REL_RMS and mx <= MAX_REL, (rms, mx)
    # the serving prefill's last position is the forward's
    last = make_prefill(port.cfg, device="cpu", last_only=True)
    with M.routing_log([], pick=lambda i: (seen[i][None],
                                           torch.ones_like(seen[i][None],
                                                           dtype=bool))):
        one = last(port, {"tokens": tokens[None]})
    assert one.shape == (1, 1, CFG["vocab_size"])
    assert torch.equal(one[0, 0], got[0, -1])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_routers_agree_but_for_near_ties(seed, monkeypatch):
    model, tokens, port = _setup(seed)
    seen = _recorded_routing(monkeypatch)
    ref.logits(CFG, model, tokens, last=False)
    log = []
    with M.routing_log(log, pick=lambda i: (seen[i][None],
                                            torch.ones_like(seen[i][None],
                                                            dtype=bool))):
        port(tokens[None])
    for r, ids in zip(log, seen):
        own = r.expert_ids[0]
        probs = r.probs[0]
        for t in torch.nonzero((own.sort(-1).values
                                != ids.sort(-1).values).any(-1))[:, 0]:
            mine, theirs = set(own[t].tolist()), set(ids[t].tolist())
            gap = (probs[t, sorted(mine - theirs)].min()
                   - probs[t, sorted(theirs - mine)].max())
            assert abs(float(gap)) <= TIE_MARGIN, (t, mine, theirs, gap)


@pytest.mark.parametrize("seed", SEEDS)
def test_decoding_through_the_latent_cache_agrees_with_the_forward(
        seed, monkeypatch):
    model, tokens, port = _setup(seed)
    seen = _recorded_routing(monkeypatch)
    want = ref.logits(CFG, model, tokens, last=False)
    n_moe = len(seen)

    def pick(i):
        step, layer = divmod(i, n_moe)
        ids = seen[layer][step:step + 1][None]
        return ids, torch.ones_like(ids, dtype=bool)
    cache = port.init_cache(1, S)
    got = []
    with M.routing_log([], pick=pick), torch.inference_mode():
        for t in range(S):
            logits, cache = port.decode_step(tokens[None, t:t + 1], cache)
            got.append(logits[0, 0])
    assert cache["pos"] == S
    assert [type(c).__name__ for c in cache["layers"]] == ["MLACache"] * 3
    rms, mx = _errors(torch.stack(got), want)
    assert rms <= REL_RMS and mx <= MAX_REL, (rms, mx)


def _uncut(cfg):
    return dict(cfg, n_routed_experts=cfg["experts_routed_over"],
                experts_held_from=0)


def test_the_eight_shares_add_up_to_the_uncut_layer():
    """Eight chips hold 2 of 16 experts each: the port's held layers, in
    float32, with the shared expert counted once, add up to the reference's
    uncut layer."""
    whole = _uncut(CFG)
    gen = torch.Generator().manual_seed(11)
    layer = ref.make_model(whole, gen, "cpu")["layers"][1]["mlp"]
    layer = {"gate": layer["gate"],
             "experts": {k: v.float() for k, v in layer["experts"].items()},
             "shared_experts": {k: v.float() for k, v in
                                layer["shared_experts"].items()}}
    x = torch.randn(40, CFG["hidden_size"], generator=gen)
    want = ref._moe(layer, x, whole, ref._same)
    arch = configs.get_reduced("deepseek-v2-lite")
    total = torch.zeros_like(x)
    for chip in range(8):
        held = (2 * chip, 2)
        mcfg = _moe_cfg(dataclasses.replace(arch, experts_held=held))
        p = {"router": layer["gate"],
             "wg": layer["experts"]["gate_proj"][2 * chip:2 * chip + 2],
             "wu": layer["experts"]["up_proj"][2 * chip:2 * chip + 2],
             "wd": layer["experts"]["down_proj"][2 * chip:2 * chip + 2],
             "shared": _swiglu(layer["shared_experts"])}
        out, _ = M.moe_forward(p, x[None], mcfg)
        total += out[0]
        # the reference's share is the same part
        share = dict(whole, experts_held_from=2 * chip, n_routed_experts=2)
        sub = {"gate": layer["gate"], "shared_experts": layer[
            "shared_experts"], "experts": {k: v[2 * chip:2 * chip + 2]
                                           for k, v in
                                           layer["experts"].items()}}
        mine = ref._moe(sub, x, share, ref._same)
        torch.testing.assert_close(out[0], mine, rtol=1e-5, atol=1e-5)
    shared = ref._swiglu(layer["shared_experts"], x, ref._same)
    torch.testing.assert_close(total - 7 * shared, want, rtol=1e-5,
                               atol=1e-5)


def test_dropless_unrenormalised_routing_is_the_references():
    arch = configs.get_reduced("deepseek-v2-lite")
    mcfg = _moe_cfg(arch)
    assert mcfg.dropless and not mcfg.renormalize and mcfg.held == (0, 2)
    gen = torch.Generator().manual_seed(5)
    d, E = arch.d_model, arch.n_experts
    router = torch.randn(d, E, generator=gen) / d ** 0.5
    # skewed: expert 3 is every token's first choice, far past the
    # capacity 1.25 would give it
    router[:, 3] += 1.0
    x = torch.randn(1, 200, d, generator=gen).abs()
    r = M.moe_route({"router": router}, x, mcfg)
    gates, ids = ref.routing({"gate": router}, x[0], ref_cfg := dict(CFG))
    assert torch.equal(r.expert_ids[0], ids)
    torch.testing.assert_close(r.gates[0], gates, rtol=0, atol=0)
    assert r.slot is None and r.dropped == 0 and bool(r.keep.all())
    assert int((ids[:, 0] == 3).sum()) == 200
    assert not ref_cfg["norm_topk_prob"]
    # renormalised and capped, as mixtral routes, the same tokens drop
    capped = dataclasses.replace(mcfg, dropless=False, renormalize=True)
    rc = M.moe_route({"router": router}, x, capped)
    assert rc.dropped > 0
    torch.testing.assert_close(rc.gates.sum(-1), torch.ones(1, 200))


def test_yarn_frequencies_and_the_softmax_scale():
    full = configs.get("deepseek-v2-lite")
    mcfg = A.MLAConfig(d_model=2048, n_heads=16, q_lora_rank=None,
                       kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                       v_head_dim=128, rope_theta=10000.0, yarn=full.yarn,
                       rope_interleaved=True)
    assert _mla_cfg(full) == mcfg
    got = A.yarn_freqs(64, 10000.0, full.yarn)
    base = [10000.0 ** (-2 * i / 64) for i in range(32)]
    for i in range(32):
        ramp = min(max((i - 10) / (23 - 10), 0.0), 1.0)
        want = base[i] / 40 * ramp + base[i] * (1 - ramp)
        assert float(got[i]) == pytest.approx(want, rel=1e-6), i
    assert float(got[5]) == pytest.approx(base[5], rel=1e-6)
    assert float(got[30]) == pytest.approx(base[30] / 40, rel=1e-6)
    assert A.mla_scale(mcfg) == pytest.approx(0.114721, abs=5e-7)
    assert A.mla_scale(mcfg) == pytest.approx(
        192 ** -0.5 * (0.1 * 0.707 * torch.log(torch.tensor(40.0)).item()
                       + 1) ** 2, rel=1e-6)
    pub = dict(CFG, qk_nope_head_dim=128, qk_rope_head_dim=64)
    torch.testing.assert_close(got, ref.yarn_inv_freq(pub), rtol=1e-6,
                               atol=0)
    assert ref.softmax_scale(pub) == pytest.approx(A.mla_scale(mcfg))


def test_the_rope_pairs_columns_as_published():
    """Rotating a vector whose only nonzero pair is (2i, 2i+1) moves
    nothing outside that pair, and the port's rotation is the
    reference's."""
    cfg = A.MLAConfig(d_model=8, n_heads=1, q_lora_rank=None, qk_rope_dim=8,
                      yarn=configs.get("deepseek-v2-lite").yarn,
                      rope_interleaved=True)
    x = torch.zeros(1, 5, 1, 8)
    x[..., 2], x[..., 3] = 1.0, 0.5
    pos = torch.arange(5)[None]
    out = A.mla_rope(x, pos, cfg)
    # de-interleaved: pair 1 comes out in columns 1 and 1 + 4
    assert torch.count_nonzero(out[0, :, 0][:, [0, 2, 3, 4, 6, 7]]) == 0
    want = ref._rope(x[0], pos[0], A.yarn_freqs(8, 10000.0, cfg.yarn), 1.0)
    torch.testing.assert_close(out[0], want)


def test_the_config_and_its_counts():
    full = configs.get("deepseek-v2-lite")
    assert "deepseek-v2-lite" not in configs.ARCH_NAMES
    assert "deepseek-v2-lite" not in configs.FULL
    assert isinstance(full, dsv2.DeepSeekV2Config)
    assert (full.n_layers, full.n_groups, full.pattern_head, full.pattern) \
        == (27, 26, ("mla",), ("mla_moe",))
    assert (full.experts_held, full.vocab) == ((0, 8), 12_800)
    # one chip's share: 2.744 B parameters (5.49 GB in bf16)
    assert full.param_count() == 2_743_861_248
    whole = dataclasses.replace(full, experts_held=None, vocab=102_400)
    assert whole.param_count() == 15_706_357_760       # "15.7B"
    assert whole.active_param_count() == 2_661_023_744
    expert = 3 * 2048 * 1408
    assert full.active_param_count() == (
        full.param_count() - 26 * (8 * expert - 6 * 8 * expert // 64))
    from repro_torch.models import build
    small = build(configs.get_reduced("deepseek-v2-lite"), device="cpu")
    assert sum(t.numel() for t in _leaves(small.params())) == \
        configs.get_reduced("deepseek-v2-lite").param_count() + _norms(small)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _norms(model):
    """The norm scales, which ``param_count`` leaves out as the zoo's do."""
    return sum(t.numel() for k, t in _named(model.params()) if k == "scale")


def _named(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _named(v, key)
    else:
        yield key, tree


def test_a_tied_or_untied_head_must_match_the_config():
    arch = configs.get_reduced("deepseek-v2-lite")
    assert not tied(arch)
    model, _, port = _setup(1)
    params = port.params()
    del params["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        Transformer(arch, params)
    zoo = configs.get_reduced("qwen3-14b")
    assert tied(zoo)
    from repro_torch.models.transformer import init_params
    p = init_params(zoo, device="cpu")
    assert "lm_head" not in p
    p["lm_head"] = {"w": torch.zeros(zoo.d_model, zoo.vocab)}
    with pytest.raises(ValueError, match="lm_head"):
        Transformer(zoo, p)
    # the JAX package's stacked layout holds neither the head nor the
    # leading dense layer
    from repro_torch.models.transformer import from_reference, to_reference
    with pytest.raises(ValueError, match="no layout"):
        to_reference(arch, port.params())
    with pytest.raises(ValueError, match="no layout"):
        from_reference(arch, {})


def test_the_reference_imports_nothing_of_the_port():
    path = Path(ref.__file__)
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            found.add((node.module or "").split(".")[0])
    assert found <= {"__future__", "math", "torch"}, found
