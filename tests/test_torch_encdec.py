"""The port's encoder-decoder path (``repro_torch.models.encdec``, the
non-causal ``attention`` and ``flash_mha(causal=False)``) against the JAX
package's, on the CPU: whisper reduced, and the attention it runs.

The same numpy-seeded inputs and the JAX model's own weights (biases and
layernorm scales set away from 0 and 1 first) go through both. On the CPU
the port's K5 calls take the kernel's plain version.

Tolerances, and why:
  * K5 against the reference's ``_sdpa`` in f32: F32_TOL = 2e-5 (rtol =
    atol), f32 sums over at most 150 keys in another order.
  * Attention, logits and decode: LOGIT_TOL = 0.02 of the largest |value|,
    as a max |diff|, as in tests/test_torch_lm.py (whose docstring says
    why: the reference casts the softmax weights to bf16 before the value
    product, K5's plain version keeps them in f32, which moves every value
    by about one bf16 ulp of the largest).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.models import attention as jA
from repro.models import build as jbuild
from repro.models import encdec as jE
from repro_torch import configs as pcfg
from repro_torch.kernels import flash_attn as tfa
from repro_torch.models import EncDec, build, params_from_numpy
from repro_torch.models import attention as tA
from repro_torch.models import encdec as tE

F32_TOL = 2e-5
LOGIT_TOL = 0.02
NAME = "whisper-base"
B, S, T, MAXLEN = 2, 12, 150, 32


def _pair(arr, dtype):
    """``arr`` in both packages, rounded to ``dtype`` once, by JAX."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape and np.isfinite(g).all()
    return float(np.abs(g - w).max() / np.abs(w).max())


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


def _perturb(tree, rng):
    """Biases ~ N(0, 0.1) and layernorm scales ~ N(1, 0.1), so that they
    change the result; everything else as given."""
    def go(t, key=None):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if key in ("b", "bi", "bo", "bias"):
            return rng.normal(0, 0.1, t.shape).astype(np.float32)
        if key == "scale":
            return rng.normal(1, 0.1, t.shape).astype(np.float32)
        return np.asarray(t, np.float32)
    return go(tree)


# ---------------------------------------------------------------------------
# K5 without the causal mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,h,kv", [(150, 150, 4, 2), (12, 150, 4, 4),
                                      (1, 7, 2, 1), (200, 130, 4, 2)])
def test_flash_mha_non_causal_matches_the_reference_sdpa(dtype, s, t, h, kv):
    """``flash_mha(causal=False)`` against the reference's unmasked
    ``_sdpa``, at T off the 128-key grid and T != S (cross attention).
    f32 within F32_TOL element-wise; bf16 within LOGIT_TOL of the largest
    value (see the module docstring)."""
    rng = np.random.default_rng(s + t)
    jq, tq = _pair(rng.normal(0, 1, (B, s, h, 16)), dtype)
    jk, tk = _pair(rng.normal(0, 1, (B, t, kv, 16)), dtype)
    jv, tv = _pair(rng.normal(0, 1, (B, t, kv, 16)), dtype)
    want = jA._sdpa(jq, jk, jv, None, h // kv)
    got = tfa.flash_mha(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype and got.shape == tuple(want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        assert _rel(got, want) <= LOGIT_TOL


def test_flash_mha_non_causal_sees_no_padded_key():
    """T = 150 is off the 128-key grid: the call equals attention over the
    150 true keys, and the same keys zero-padded to 256 (what the causal
    call's padding would hand an unmasked kernel) give another answer."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, n, 2, 16)).astype(
        np.float32)) for n in (150, 150, 150))
    got = tfa.flash_mha(q, k, v, causal=False)
    flat = [x.transpose(1, 2).reshape(2, 150, 16) for x in (q, k, v)]
    want = tfa.flash_attention_ref(*flat, causal=False)
    want = want.reshape(1, 2, 150, 16).transpose(1, 2).reshape(1, 150, 32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    padded = [torch.nn.functional.pad(x, (0, 0, 0, 106)) for x in flat]
    diluted = tfa.flash_attention_ref(*padded, causal=False)[:, :150]
    diluted = diluted.reshape(1, 2, 150, 16).transpose(1, 2).reshape(1, 150,
                                                                     32)
    assert _rel(diluted, want) > 5 * LOGIT_TOL


def test_flash_mha_checks_the_mask_against_the_shapes():
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 12, 2, 16))
    with pytest.raises(ValueError, match="causal=True"):
        tfa.flash_mha(q, kv, kv)                  # causal needs T == S
    with pytest.raises(ValueError, match="window"):
        tfa.flash_mha(q, kv, kv, causal=False, window=4)
    with pytest.raises(ValueError, match="causal=False"):
        tfa.flash_mha(q, kv[:, :0], kv[:, :0], causal=False)
    assert tfa.flash_mha(q, kv, kv, causal=False).shape == (1, 8, 32)


@pytest.mark.parametrize("s", [16, 150])
def test_non_causal_attention_matches_jax(s):
    """``attention`` with ``causal=False`` (whisper's encoder: no RoPE, no
    mask) against the reference's dense ``_sdpa`` with no mask. S = 150 is
    not a multiple of 128, so a visible padded key would fail here; a
    window in the config is ignored without the causal mask, as in the
    reference."""
    cfg = rcfg.get_reduced(NAME)
    jcfg = jA.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                         n_kv=2, head_dim=cfg.hd, causal=False,
                         use_rope=False)
    tcfg = tA.AttnConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(s)
    p = _perturb(jax.tree.map(np.asarray, jA.attn_init(
        jax.random.PRNGKey(3), dataclasses.replace(jcfg, qkv_bias=True))),
        rng)
    jx, tx = _pair(rng.normal(0, 1, (B, s, cfg.d_model)), "bfloat16")
    want = jA.attention(jax.tree.map(jnp.asarray, p), jx, jcfg)
    for c in (tcfg, dataclasses.replace(tcfg, window=4)):
        got = tA.attention(_tensors(p), tx, c)
        assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
        assert _rel(got, want) <= LOGIT_TOL
    causal = tA.attention(_tensors(p), tx,
                          dataclasses.replace(tcfg, causal=True))
    assert _rel(causal, want) > 5 * LOGIT_TOL


# ---------------------------------------------------------------------------
# whisper reduced
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper():
    """(JAX model, JAX params, the port's EncDec, tokens, frames in both)
    for whisper reduced, the same weights."""
    cfg = rcfg.get_reduced(NAME)
    jm = jbuild(cfg)
    rng = np.random.default_rng(20)
    tree = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                    rng)
    pm = params_from_numpy(pcfg.get_reduced(NAME), tree, device="cpu")
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = _pair(rng.normal(0, 1, (B, T, cfg.d_model)), "bfloat16")
    return jm, jax.tree.map(jnp.asarray, tree), tree, pm, toks, frames


def test_params_from_numpy_unstacks_the_layers(whisper):
    """``enc`` and ``dec``, stacked on axis 0 by the reference's vmap init,
    become one dict a layer, in order: each weight equals the reference's
    row i rounded to bf16; the layernorms (``ln1``-``ln3``, ``enc_norm``,
    ``dec_norm``) stay f32 and exact."""
    _, _, tree, pm, _, _ = whisper
    cfg = pm.cfg
    assert isinstance(pm, EncDec)
    assert (len(pm.enc), len(pm.dec)) == (cfg.enc_layers, cfg.n_layers)

    def bf16(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    for mods, stacked in ((pm.enc, tree["enc"]), (pm.dec, tree["dec"])):
        for i, layer in enumerate(mods):
            for name, t in layer.named_parameters():
                keys = name.split(".")
                want = stacked
                for k in keys:
                    want = want[k]
                want = want[i]
                if keys[0].startswith("ln"):
                    assert t.dtype == torch.float32
                    assert np.array_equal(t.numpy(), want)
                else:
                    assert t.dtype == torch.bfloat16
                    assert np.array_equal(t.float().numpy(), bf16(want))
    for k in ("enc_norm", "dec_norm"):
        for leaf in ("scale", "bias"):
            t = getattr(pm, k)[leaf]
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy(), tree[k][leaf])
    assert pm.dec_pos.dtype == torch.bfloat16
    assert np.array_equal(pm.dec_pos.float().numpy(), bf16(tree["dec_pos"]))
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in pm.parameters()) == n_ref


def test_cross_attention_matches_jax(whisper):
    """Decoder layer 0's cross attention, S_dec = 12 queries over T = 150
    encoder states: one non-causal K5 call in the port."""
    jm, jp, _, pm, _, _ = whisper
    cfg = rcfg.get_reduced(NAME)
    rng = np.random.default_rng(21)
    jq, tq = _pair(rng.normal(0, 1, (B, S, cfg.d_model)), "bfloat16")
    je, te = _pair(rng.normal(0, 1, (B, T, cfg.d_model)), "bfloat16")
    jl = jax.tree.map(lambda a: a[0], jp["dec"])
    want = jE._cross_attention(jl["cross"], jq, je, cfg)
    got = tE._cross_attention(pm.dec[0]["cross"], tq, te, pm.cfg)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= LOGIT_TOL
    # decode's form: the same K/V, projected once, attended in plain PyTorch
    jk, jv = (jE.B.dense(jl["cross"][w], je).reshape(B, T, cfg.n_kv, cfg.hd)
              for w in ("wk", "wv"))
    tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jk, jv))
    cached = tE._cross_attention_cached(pm.dec[0]["cross"], tq, tk, tv,
                                        pm.cfg)
    assert _rel(cached, want) <= LOGIT_TOL


def test_encode_matches_jax(whisper):
    jm, jp, _, pm, _, (jf, tf) = whisper
    want = jm.encode(jp, jf)
    got = pm.encode(tf)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= LOGIT_TOL


def test_forward_and_decode_match_jax(whisper):
    """The prefill's logits, then six decode steps from the encoder's cross
    K/V and empty self caches: each step's logits against the reference's
    decode step, and its caches' cross K/V against the reference's."""
    jm, jp, _, pm, toks, (jf, tf) = whisper
    want, jaux = jm.forward(jp, jnp.asarray(toks), jf)
    got, aux = pm(torch.from_numpy(toks).long(), tf)
    assert got.dtype == torch.float32 and got.shape == (B, S, pm.cfg.vocab)
    assert float(aux) == float(jaux) == 0.0
    assert _rel(got, want) <= LOGIT_TOL
    jc = jm.init_cache(jp, jf, MAXLEN)
    tc = pm.init_cache(tf, MAXLEN)
    assert len(tc["dec"]) == pm.cfg.n_layers
    for i, c in enumerate(tc["dec"]):
        assert c["xk"].shape == (B, T, pm.cfg.n_kv, pm.cfg.hd)
        assert _rel(c["xk"], jc["dec"]["xk"][i]) <= LOGIT_TOL
        assert c["self"].k.shape == (B, MAXLEN, pm.cfg.n_kv, pm.cfg.hd)
    for t in range(6):
        w, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        g, tc = pm.decode_step(torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        assert g.shape == (B, 1, pm.cfg.vocab)
        assert _rel(g, w) <= LOGIT_TOL
        # and the port's own decode reproduces its prefill
        assert _rel(g, got[:, t:t + 1]) <= LOGIT_TOL
    assert tc["pos"] == int(jc["pos"]) == 6
    assert tc["dec"][0]["self"].length == 6


@pytest.mark.parametrize("pos", [32767, 32768, 40000])
def test_decode_past_the_learned_positions_matches_jax(whisper, pos):
    """A decode step at ``pos`` >= 32768, past the rows of ``dec_pos``,
    takes its last row, as the reference's ``dynamic_slice_in_dim``
    clamps: logits against the reference's step on the same weights and
    cache, and equal to the port's own step at 32767."""
    jm, jp, _, pm, toks, (jf, tf) = whisper
    tok = toks[:, :1]
    jc = jm.init_cache(jp, jf, MAXLEN)
    jc = {**jc, "pos": jnp.asarray(pos, jnp.int32)}
    want, _ = jm.decode_step(jp, jnp.asarray(tok), jc)
    got, tc = pm.decode_step(torch.from_numpy(tok).long(),
                             {**pm.init_cache(tf, MAXLEN), "pos": pos})
    assert tc["pos"] == pos + 1
    assert _rel(got, want) <= LOGIT_TOL
    last, _ = pm.decode_step(torch.from_numpy(tok).long(),
                             {**pm.init_cache(tf, MAXLEN), "pos": 32767})
    assert torch.equal(got, last)


def test_build_whisper_on_the_cpu():
    """``build`` returns an EncDec with the reference's parameter count,
    the same weights for the same seed, and finite logits."""
    cfg = pcfg.get_reduced(NAME)
    model = build(cfg, device="cpu", seed=3)
    assert isinstance(model, EncDec) and model.device == torch.device("cpu")
    shapes = jax.eval_shape(jbuild(rcfg.get_reduced(NAME)).init,
                            jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    again = build(cfg, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  again.parameters()))
    frames = torch.zeros((1, 10, cfg.d_model), dtype=torch.bfloat16)
    lg, _ = model(torch.zeros((1, 4), dtype=torch.long), frames)
    assert lg.shape == (1, 4, cfg.vocab) and bool(torch.isfinite(lg).all())


def test_encdec_refuses_a_decoder_only_config():
    cfg = pcfg.get_reduced("qwen3-14b")
    with pytest.raises(ValueError, match="enc_layers"):
        EncDec(cfg, {"enc": [], "dec": []})
