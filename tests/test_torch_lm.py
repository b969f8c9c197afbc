"""The port's LM substrate (``models.{blocks,attention,transformer}``,
``build``) against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both; the weights are the JAX
model's own, carried across by ``params_from_numpy`` (biases and norm
scales set away from 0 and 1 first, so that those paths count). On the CPU
the port's attention runs K5's plain version.

Tolerances, and why:
  * f32 blocks: F32_TOL = 2e-5 (rtol = atol), f32 sums over at most 256
    terms in another order.
  * bf16 blocks: BF16_TOL = 2e-2 (rtol = atol): both sides round the
    output to bf16 (2^-8 relative apart), and a bf16 intermediate (silu,
    g*u, the GELU input) may round the other way; a few ulps.
  * Attention, the model's logits, decode: LOGIT_TOL = 0.02 of the largest
    |value|, as a max |diff|. The reference's ``_sdpa`` casts the
    normalized softmax weights to bf16 before the second product; K5's
    plain version keeps them in f32 and rounds the output once. Through
    the residual stream that moves every logit by about one bf16 ulp of the
    largest one (2^-8, 0.4%), whatever its own size, so an element-wise
    rtol fails on the small logits while the error is at rounding level.
    0.02 is five such ulps; a wrong position, mask, cache slot or head
    mapping moves the logits by order 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.models import attention as jA
from repro.models import blocks as jB
from repro.models import build as jbuild
from repro_torch import configs as pcfg
from repro_torch.models import attention as tA
from repro_torch.models import blocks as tB
from repro_torch.models import build, params_from_numpy, transformer as tT

F32_TOL, BF16_TOL = 2e-5, 2e-2
LOGIT_TOL = 0.02
DENSE = ["qwen3-14b", "granite-8b", "qwen1.5-32b"]
NOT_BUILT = [n for n in rcfg.ARCH_NAMES if n not in DENSE]
B, S, MAXLEN = 2, 16, 32


def _pair(arr, dtype):
    """``arr`` in both packages, rounded to ``dtype`` once, by JAX."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _close(got, want, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    g = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                   else jnp.asarray(got, jnp.float32), np.float64)
    w = np.asarray(want.float().numpy() if isinstance(want, torch.Tensor)
                   else jnp.asarray(want, jnp.float32), np.float64)
    assert g.shape == w.shape and np.isfinite(g).all()
    return float(np.abs(g - w).max() / np.abs(w).max())


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request):
    return request.param


def _x(rng, dtype, shape=(2, 5, 64)):
    return _pair(rng.normal(0, 1, shape), dtype)


def test_rmsnorm_and_layernorm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, dtype)
    p = {"scale": rng.normal(1, 0.2, 64).astype(np.float32),
         "bias": rng.normal(0, 0.2, 64).astype(np.float32)}
    _close(tB.rmsnorm(_tensors({"scale": p["scale"]}), tx),
           jB.rmsnorm({"scale": jnp.asarray(p["scale"])}, jx), dtype)
    _close(tB.layernorm(_tensors(p), tx),
           jB.layernorm(jax.tree.map(jnp.asarray, p), jx), dtype)


@pytest.mark.parametrize("bias", [False, True])
def test_dense(dtype, bias):
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, dtype)
    p = {"w": rng.normal(0, 0.125, (64, 48)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(0, 0.5, 48).astype(np.float32)
    _close(tB.dense(_tensors(p), tx),
           jB.dense(jax.tree.map(jnp.asarray, p), jx), dtype)


def test_swiglu_and_gelu_mlp(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, dtype)
    sw = {k: rng.normal(0, 0.125, s).astype(np.float32) for k, s in
          (("wg", (64, 128)), ("wu", (64, 128)), ("wd", (128, 64)))}
    _close(tB.swiglu(_tensors(sw), tx),
           jB.swiglu(jax.tree.map(jnp.asarray, sw), jx), dtype)
    ge = {k: rng.normal(0, 0.125, s).astype(np.float32) for k, s in
          (("wi", (64, 128)), ("wo", (128, 64)), ("bi", (128,)),
           ("bo", (64,)))}
    _close(tB.gelu_mlp(_tensors(ge), tx),
           jB.gelu_mlp(jax.tree.map(jnp.asarray, ge), jx), dtype)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to approximate=True: the port's GELU is
    torch's tanh form, which the exact erf form is not."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(tanh.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(erf.numpy() - want).max() > 1e-4


def test_embed_and_unembed(dtype):
    rng = np.random.default_rng(3)
    emb = rng.normal(0, 1, (256, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (2, 7))
    got = tB.embed({"emb": torch.from_numpy(emb)}, torch.from_numpy(toks))
    want = jB.embed({"emb": jnp.asarray(emb)}, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    jx, tx = _x(rng, dtype)
    lg = tB.unembed({"emb": torch.from_numpy(emb)}, tx)
    assert lg.dtype == torch.float32
    if dtype == "float32":
        _close(lg, jB.unembed({"emb": jnp.asarray(emb)}, jx), dtype)
    else:
        # bf16 products rounded to bf16, then cast to f32 on both sides.
        np.testing.assert_allclose(
            lg.numpy(), np.asarray(jB.unembed({"emb": jnp.asarray(emb)}, jx)),
            rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6, 1e7])
@pytest.mark.parametrize("hd", [16, 128])
def test_rope_freqs(theta, hd):
    """f32 theta ** (arange / hd); torch's and XLA's pow may differ by an
    ulp, so within F32_TOL (relative), not ==."""
    np.testing.assert_allclose(tB.rope_freqs(hd, theta).numpy(),
                               np.asarray(jB.rope_freqs(hd, theta)),
                               rtol=F32_TOL, atol=0)


@pytest.mark.parametrize("mrope", [None, (4, 2, 2)])
def test_apply_rope(dtype, mrope):
    rng = np.random.default_rng(4)
    jx, tx = _x(rng, dtype, (2, 9, 3, 16))
    if mrope is None:
        pos = rng.integers(0, 5000, (2, 9))
    else:
        pos = rng.integers(0, 5000, (2, 9, 3))
    # Angles up to 5000 rad: an ulp of the f32 angle is 5e-4 there, so the
    # two packages' sin/cos may differ by that much before the bf16 cast.
    tol = 2e-3 if dtype == "float32" else BF16_TOL
    got = tB.apply_rope(tx, torch.from_numpy(pos), theta=1e4,
                        mrope_sections=mrope)
    want = jB.apply_rope(jx, jnp.asarray(pos), theta=1e4,
                         mrope_sections=mrope)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_init_scales():
    """1/sqrt(d_in) for weights, 1.0 for the embedding, from an explicit
    generator on an explicit device."""
    g = torch.Generator().manual_seed(0)
    w = tB.dense_init(g, 4096, 512, bias=True, device="cpu")
    assert abs(float(w["w"].std()) - 4096 ** -0.5) < 1e-3 * 4096 ** -0.5 * 50
    assert float(w["b"].abs().max()) == 0.0
    e = tB.embedding_init(g, 1000, 512, dtype=torch.bfloat16, device="cpu")
    assert e["emb"].dtype == torch.bfloat16
    assert abs(float(e["emb"].float().std()) - 1.0) < 0.01
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    assert torch.equal(tB.swiglu_init(g1, 8, 16)["wd"],
                       tB.swiglu_init(g2, 8, 16)["wd"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_case(name, rng, s):
    """A reduced arch's attention config and the JAX params (biases and
    norm scales off 0 and 1), the same input x in bf16 in both."""
    cfg = rcfg.get_reduced(name)
    jcfg = jA.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                         n_kv=cfg.n_kv, head_dim=cfg.hd,
                         qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                         rope_theta=cfg.rope_theta)
    tcfg = tA.AttnConfig(**dataclasses.asdict(jcfg))
    p = _perturb(jax.tree.map(np.asarray,
                              jA.attn_init(jax.random.PRNGKey(1), jcfg)), rng)
    jx, tx = _pair(rng.normal(0, 1, (1, s, cfg.d_model)), "bfloat16")
    return jcfg, tcfg, p, jx, tx


@pytest.mark.parametrize("name,s", [("qwen3-14b", 16), ("qwen1.5-32b", 16),
                                    ("granite-8b", 200), ("qwen3-14b", 4224)])
def test_attention_matches_jax(name, s):
    """S = 16 and 200 take the reference's dense ``_sdpa``; S = 4224 is
    above DENSE_ATTN_MAX_SEQ and takes its chunked flash scan. Both are one
    K5 call in the port."""
    assert (s > jA.DENSE_ATTN_MAX_SEQ) == (s == 4224)
    rng = np.random.default_rng(s)
    jcfg, tcfg, p, jx, tx = _attn_case(name, rng, s)
    want = jA.attention(jax.tree.map(jnp.asarray, p), jx, jcfg)
    got = tA.attention(_tensors(p), tx, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= LOGIT_TOL


def test_attention_refuses_window_and_non_causal():
    cfg = tA.AttnConfig(d_model=64, n_heads=4, n_kv=2, head_dim=16)
    p = _tensors(jax.tree.map(np.asarray, jA.attn_init(
        jax.random.PRNGKey(0), jA.AttnConfig(**dataclasses.asdict(cfg)))))
    x = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="M9b"):
        tA.attention(p, x, dataclasses.replace(cfg, window=4))
    with pytest.raises(NotImplementedError, match="M9c"):
        tA.attention(p, x, dataclasses.replace(cfg, causal=False))


def test_cache_store_gives_the_same_int8_bytes():
    rng = np.random.default_rng(5)
    # Half-way points of the 2^-3 grid (round half to even) and values past
    # the int8 range (clipped).
    k = np.concatenate([rng.normal(0, 4, 4096),
                        (np.arange(-40, 40) + 0.5) / 8.0,
                        np.array([-17.0, -16.1, 15.95, 16.0, 20.0])])
    jk, tk = _pair(k.reshape(1, -1, 1, 1), "bfloat16")
    got = tA._cache_store(tk, torch.int8)
    want = jA._cache_store(jk, jnp.int8)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tA._cache_load(got).float().numpy(),
                          np.asarray(jA._cache_load(want), np.float32))


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_decode_step_matches_jax(cache_dtype, window):
    """Eight one-token steps through a cache of 6 (the last steps clamp the
    slot, as the reference's dynamic_update_slice does) or a ring buffer of
    4 (window): outputs and cache contents equal the reference's."""
    rng = np.random.default_rng(6)
    jcfg, tcfg, p, jx, tx = _attn_case("qwen3-14b", rng, 8)
    jcfg = dataclasses.replace(jcfg, cache_dtype=cache_dtype, window=window)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype, window=window)
    jp, tp = jax.tree.map(jnp.asarray, p), _tensors(p)
    n = window or 6
    jc, tc = jA.init_cache(jcfg, 1, n), tA.init_cache(tcfg, 1, n)
    assert tc.k.dtype == getattr(torch, cache_dtype)
    for t in range(8):
        want, jc = jA.decode_step(jp, jx[:, t:t + 1], jc, jcfg)
        got, tc = tA.decode_step(tp, tx[:, t:t + 1], tc, tcfg)
        assert tc.length == int(jc.length) == t + 1
        assert _rel(got, want) <= LOGIT_TOL
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            if cache_dtype == "int8":
                # An int8 code may differ by one where the bf16 k/v rounded
                # the other way right at a half-way point.
                d = np.abs(a.numpy().astype(int) - np.asarray(b).astype(int))
                assert d.max() <= 1 and (d > 0).mean() < 0.01
            else:
                assert _rel(a, b) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _perturb(tree, rng):
    """Biases ~ N(0, 0.1) and norm scales ~ N(1, 0.1), so that the QKV bias
    and the norms' scales change the result; everything else as given."""
    def go(t, key=None):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        if key == "b":
            return rng.normal(0, 0.1, t.shape).astype(np.float32)
        if key == "scale":
            return rng.normal(1, 0.1, t.shape).astype(np.float32)
        return np.asarray(t, np.float32)
    return go(tree)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(arch, JAX model, JAX params, port model, tokens) for one reduced
    dense arch, with the same weights."""
    name = request.param
    cfg = rcfg.get_reduced(name)
    jm = jbuild(cfg)
    rng = np.random.default_rng(10)
    tree = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                    rng)
    pm = params_from_numpy(pcfg.get_reduced(name), tree, device="cpu")
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return name, jm, jax.tree.map(jnp.asarray, tree), pm, toks


def test_params_from_numpy_layout(pair):
    name, jm, jp, pm, _ = pair
    cfg = pm.cfg
    assert len(pm.layers) == cfg.n_layers
    assert pm.embedding["emb"].dtype == torch.bfloat16
    assert pm.final_norm["scale"].dtype == torch.float32
    l1 = pm.layers[1]
    assert l1["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert l1["ln2"]["scale"].dtype == torch.float32
    assert np.array_equal(
        l1["mlp"]["wd"].float().numpy(),
        np.asarray(jp["groups"]["b0"]["mlp"]["wd"][1].astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    assert ("b" in l1["attn"]["wq"]) == cfg.qkv_bias
    assert ("qnorm" in l1["attn"]) == cfg.qk_norm
    assert not any(p.requires_grad for p in pm.parameters())


def test_forward_matches_jax(pair):
    name, jm, jp, pm, toks = pair
    want, jaux = jm.forward(jp, jnp.asarray(toks))
    got, aux = pm(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    assert got.shape == (B, S, pm.cfg.vocab)
    assert float(aux) == float(jaux) == 0.0
    assert _rel(got, want) <= LOGIT_TOL


def test_decode_matches_jax(pair):
    """Six decode steps from an empty cache, both packages."""
    name, jm, jp, pm, toks = pair
    jc, tc = jm.init_cache(B, MAXLEN), pm.init_cache(B, MAXLEN)
    for t in range(6):
        want, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        got, tc = pm.decode_step(torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        assert got.shape == (B, 1, pm.cfg.vocab)
        assert _rel(got, want) <= LOGIT_TOL
    assert tc["pos"] == int(jc["pos"]) == 6


def test_embeds_and_positions_match_jax(pair):
    """The stub-frontend input (embeds) and explicit positions."""
    name, jm, jp, pm, toks = pair
    rng = np.random.default_rng(11)
    je, te = _pair(rng.normal(0, 1, (B, S, pm.cfg.d_model)), "bfloat16")
    pos = np.broadcast_to(np.arange(S) * 3 + 5, (B, S))
    want, _ = jm.forward(jp, None, embeds=je, positions=jnp.asarray(pos))
    got, _ = pm(None, embeds=te, positions=torch.from_numpy(pos.copy()))
    assert _rel(got, want) <= LOGIT_TOL


def test_decode_matches_forward_prefix():
    """The port's own decode reproduces its full-sequence logits, as
    tests/test_arch_smoke.py holds the reference's (granite, B = 2, six
    tokens). See the module docstring for the bound."""
    cfg = pcfg.get_reduced("granite-8b")
    model = build(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (B, 6)))
    full, _ = model(toks)
    cache = model.init_cache(B, MAXLEN)
    outs = []
    for t in range(6):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert _rel(dec, full) <= LOGIT_TOL
    assert bool((dec.argmax(-1) == full.argmax(-1)).all())


@pytest.mark.parametrize("name", DENSE)
def test_build_on_the_cpu(name):
    cfg = pcfg.get_reduced(name)
    model = build(cfg, device="cpu", seed=3)
    assert model.device == torch.device("cpu")
    assert len(model.layers) == cfg.n_layers
    n = sum(p.numel() for p in model.parameters())
    # param_count counts the matmul weights and the embedding, not the
    # norm scales and biases.
    extra = sum(p.numel() for name_, p in model.named_parameters()
                if name_.endswith(".scale") or name_.endswith(".b"))
    assert n - extra == cfg.param_count()
    again = build(cfg, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  again.parameters()))
    lg, _ = model(torch.zeros((1, 4), dtype=torch.long))
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("name", NOT_BUILT)
def test_build_refuses_the_other_archs(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 M9"):
        build(pcfg.get_reduced(name), device="cpu")


@pytest.mark.parametrize("over", [dict(window=8), dict(n_experts=4),
                                  dict(mrope_sections=(4, 2, 2))])
def test_build_refuses_window_experts_mrope(over):
    cfg = dataclasses.replace(pcfg.get_reduced("qwen3-14b"), **over)
    with pytest.raises(NotImplementedError, match="M9b"):
        build(cfg, device="cpu")


def test_block_kinds_not_ported_raise():
    cfg = pcfg.get_reduced("qwen3-14b")
    for kind, item in (("attn_moe", "M9b"), ("mla", "M9b"), ("rglru", "M9c"),
                       ("mlstm", "M9c"), ("slstm", "M9c")):
        with pytest.raises(NotImplementedError, match=item):
            tT.block_init(torch.Generator(), kind, cfg)


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present, so the default does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        build(pcfg.get_reduced("qwen3-14b"))
