"""The port's LM substrate (``models.{blocks,attention,moe,recurrent,
transformer}``, ``build``) against the JAX package's, on the CPU: the dense
archs, mixtral (MoE top-2, sliding window), llama4 (MoE top-1 with the
shared expert), minicpm3 (MLA), qwen2-vl (M-RoPE, the vision stub's
embeds), recurrentgemma (RG-LRU and local attention) and xlstm (mLSTM and
sLSTM); whisper's encoder-decoder is in tests/test_torch_encdec.py.

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
  * The MoE archs (mixtral, llama4) are held to the reference run op by
    op (``jax.disable_jit()``), at MOE_LOGIT_TOL = 0.04. Compiled, XLA
    fuses the bf16 elementwise chains and rounds the router's input
    otherwise: a router near-tie then flips an expert pick and moves that
    token by order 1. Measured on mixtral reduced (PRNGKey(5), the wrap
    test's weights): the reference's own compiled and op-by-op layer 0
    pick other experts for two tokens, whose top-2 probabilities are
    0.26% and 0.12% apart, and its two forwards differ by 0.92 of the
    largest logit; the port follows the op-by-op one (0.014). The experts'
    outputs are large (the reference initializes a stacked expert weight
    at 1/sqrt(E)), so an ulp of the router's input moves the logits more
    than in a dense model: the reference's own compiled and op-by-op
    forwards differ by 0.022 of the largest logit at llama4 reduced and
    0.013 at mixtral reduced. MOE_LOGIT_TOL is about twice that; a wrong
    expert, gate or slot moves a token by order 1. The routing itself is
    held exactly in tests/test_torch_moe.py.
  * The models' MoE aux loss: AUX_TOL = 1e-3 relative. It is an f32
    function of each MoE layer's input, which the two packages round to
    bf16 apart by an ulp here and there.
  * xlstm (F32_DRIVEN) is held as a whole model in f32, at LOGIT_TOL. In
    bf16 its reduced model (16 mLSTM/sLSTM blocks, the JAX init's weights)
    amplifies rounding: each of the port's blocks, fed the reference's
    own input, is within one bf16 ulp of the reference's output (at most
    0.0075 of the largest value; tests/test_torch_recurrent.py holds every
    block so, in bf16), but chained through the 16 blocks that grows to
    0.16-0.23 of the largest logit, and the reference's own compiled and
    op-by-op bf16 forwards differ by 0.10 (measured on PRNGKey(0)'s
    weights). So the forward, decode and embeds comparisons feed both
    packages the f32 embedding rows (``embeds``), with every weight first
    rounded to a bf16 value so that the port's bf16 weights equal the
    reference's f32 ones: the same function in f32, which matches within
    1e-5.
"""
import contextlib
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
AUX_TOL = 1e-3
MOE_LOGIT_TOL = 0.04
BUILT = ["qwen3-14b", "granite-8b", "qwen1.5-32b", "mixtral-8x7b",
         "llama4-maverick-400b-a17b", "minicpm3-4b", "qwen2-vl-72b",
         "recurrentgemma-2b", "xlstm-350m"]
#: Archs whose whole-model comparison runs in f32 (module docstring).
F32_DRIVEN = ("xlstm-350m",)
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


def _ref_mode(cfg):
    """How the reference runs for ``cfg``: op by op for the MoE archs (see
    the module docstring), compiled otherwise."""
    return jax.disable_jit() if cfg.n_experts else contextlib.nullcontext()


def _logit_tol(cfg) -> float:
    return MOE_LOGIT_TOL if cfg.n_experts else LOGIT_TOL


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

def _attn_case(name, rng, s, window=None):
    """A reduced arch's attention config and the JAX params (biases and
    norm scales off 0 and 1), the same input x in bf16 in both."""
    cfg = rcfg.get_reduced(name)
    jcfg = jA.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                         n_kv=cfg.n_kv, head_dim=cfg.hd,
                         qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                         rope_theta=cfg.rope_theta, window=window)
    tcfg = tA.AttnConfig(**dataclasses.asdict(jcfg))
    p = _perturb(jax.tree.map(np.asarray,
                              jA.attn_init(jax.random.PRNGKey(1), jcfg)), rng)
    jx, tx = _pair(rng.normal(0, 1, (1, s, cfg.d_model)), "bfloat16")
    return jcfg, tcfg, p, jx, tx


@pytest.mark.parametrize("name,s,window", [
    ("qwen3-14b", 16, None), ("qwen1.5-32b", 16, None),
    ("granite-8b", 200, None), ("qwen3-14b", 4224, None),
    ("mixtral-8x7b", 16, 8), ("mixtral-8x7b", 200, 63),
    ("mixtral-8x7b", 4224, 1000)])
def test_attention_matches_jax(name, s, window):
    """S = 16 and 200 take the reference's dense ``_sdpa`` (with
    ``_causal_mask(S, S, window)``); S = 4224 is above DENSE_ATTN_MAX_SEQ
    and takes its chunked flash scan (the window masked tile by tile). All
    are one K5 call in the port, the window passed to it."""
    assert (s > jA.DENSE_ATTN_MAX_SEQ) == (s == 4224)
    rng = np.random.default_rng(s + (window or 0))
    jcfg, tcfg, p, jx, tx = _attn_case(name, rng, s, window)
    want = jA.attention(jax.tree.map(jnp.asarray, p), jx, jcfg)
    got = tA.attention(_tensors(p), tx, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= LOGIT_TOL
    if window is not None:
        # the window binds: the same call without it is far off
        free = tA.attention(_tensors(p), tx,
                            dataclasses.replace(tcfg, window=None))
        assert _rel(free, want) > 5 * LOGIT_TOL


@pytest.mark.parametrize("name,s", [("qwen3-14b", 16), ("granite-8b", 200)])
def test_non_causal_attention_matches_jax(name, s):
    """``causal=False`` with RoPE, GQA and (qwen3) qk-norm: one K5 call
    without the mask against the reference's dense ``_sdpa`` with no mask.
    S = 200 is off the 128-key grid, so a visible padded key would show;
    the same call with the causal mask is far off."""
    rng = np.random.default_rng(30 + s)
    jcfg, tcfg, p, jx, tx = _attn_case(name, rng, s)
    jcfg = dataclasses.replace(jcfg, causal=False)
    tcfg = dataclasses.replace(tcfg, causal=False)
    want = jA.attention(jax.tree.map(jnp.asarray, p), jx, jcfg)
    got = tA.attention(_tensors(p), tx, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= LOGIT_TOL
    causal = tA.attention(_tensors(p), tx,
                          dataclasses.replace(tcfg, causal=True))
    assert _rel(causal, want) > 5 * LOGIT_TOL


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_case(rng, s):
    """minicpm3's reduced MLA config, the JAX params (norm scales off 1),
    and the same x in bf16 in both."""
    cfg = rcfg.get_reduced("minicpm3-4b")
    m = cfg.mla
    jcfg = jA.MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        q_lora_rank=m.q_lora_rank,
                        kv_lora_rank=m.kv_lora_rank,
                        qk_nope_dim=m.qk_nope_dim, qk_rope_dim=m.qk_rope_dim,
                        v_head_dim=m.v_head_dim, rope_theta=cfg.rope_theta)
    tcfg = tA.MLAConfig(**dataclasses.asdict(jcfg))
    p = _perturb(jax.tree.map(np.asarray,
                              jA.mla_init(jax.random.PRNGKey(2), jcfg)), rng)
    jx, tx = _pair(rng.normal(0, 1, (1, s, cfg.d_model)), "bfloat16")
    return jcfg, tcfg, p, jx, tx


@pytest.mark.parametrize("s", [16, 4224])
def test_mla_attention_matches_jax(s):
    """S = 16 takes the reference's dense MLA branch, S = 4224 its chunked
    flash scan; both are one K5 call in the port, on the concatenated
    (nope | rope) width with v zero-padded to it."""
    rng = np.random.default_rng(20 + s)
    jcfg, tcfg, p, jx, tx = _mla_case(rng, s)
    want = jA.mla_attention(jax.tree.map(jnp.asarray, p), jx, jcfg)
    got = tA.mla_attention(_tensors(p), tx, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= LOGIT_TOL


def test_mla_decode_step_matches_jax():
    """Twenty one-token steps through a latent cache of 16: the last four
    clamp the slot, as the reference's dynamic_update_slice does. Outputs
    and both caches equal the reference's within LOGIT_TOL."""
    rng = np.random.default_rng(21)
    jcfg, tcfg, p, jx, tx = _mla_case(rng, 20)
    jp, tp = jax.tree.map(jnp.asarray, p), _tensors(p)
    jc = jA.mla_init_cache(jcfg, 1, 16)
    tc = tA.mla_init_cache(tcfg, 1, 16)
    assert tc.c_kv.dtype == torch.bfloat16 and tc.c_kv.shape == jc.c_kv.shape
    for t in range(20):
        want, jc = jA.mla_decode_step(jp, jx[:, t:t + 1], jc, jcfg)
        got, tc = tA.mla_decode_step(tp, tx[:, t:t + 1], tc, tcfg)
        assert tc.length == int(jc.length) == t + 1
        assert got.shape == tuple(want.shape)
        assert _rel(got, want) <= LOGIT_TOL
        assert _rel(tc.c_kv, jc.c_kv) <= LOGIT_TOL
        assert _rel(tc.k_rope, jc.k_rope) <= LOGIT_TOL


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


@pytest.fixture(scope="module", params=BUILT)
def pair(request):
    """(arch, JAX model, JAX params, port model, tokens) for one reduced
    arch that ``build`` takes, with the same weights (for F32_DRIVEN, every
    weight rounded to a bf16 value first)."""
    name = request.param
    cfg = rcfg.get_reduced(name)
    jm = jbuild(cfg)
    rng = np.random.default_rng(10)
    tree = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                    rng)
    if name in F32_DRIVEN:
        tree = jax.tree.map(_bf16, tree)
    pm = params_from_numpy(pcfg.get_reduced(name), tree, device="cpu")
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return name, jm, jax.tree.map(jnp.asarray, tree), pm, toks


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _feed(name, jp, pm, toks):
    """((tokens, embeds) for JAX, the same for the port): the token ids as
    served, or for F32_DRIVEN archs the f32 embedding rows (module
    docstring)."""
    tt = torch.from_numpy(np.asarray(toks)).long()
    if name not in F32_DRIVEN:
        return (jnp.asarray(toks), None), (tt, None)
    return ((None, jp["embedding"]["emb"][jnp.asarray(toks)]),
            (None, pm.embedding["emb"].float()[tt]))


def _at(x, t):
    return None if x is None else x[:, t:t + 1]


def _leaves(tree, path=()):
    """(key path, leaf) of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_params_from_numpy_layout(pair):
    """Every layer's leaves in place, in bf16 but the norms, the MoE router,
    RG-LRU's ``lam`` and the sLSTM's gate matrices (f32); every leaf of
    every layer equals the reference's (exact where f32, rounded to bf16
    elsewhere)."""
    name, jm, jp, pm, _ = pair
    cfg = pm.cfg
    assert len(pm.layers) == cfg.n_layers
    assert pm.embedding["emb"].dtype == torch.bfloat16
    assert pm.final_norm["scale"].dtype == torch.float32
    for kind, lp in zip(pm.kinds, pm.layers):
        assert lp["ln1"]["scale"].dtype == torch.float32
        if kind in ("mlstm", "slstm"):
            assert "ln2" not in lp and "mlp" not in lp
            continue
        assert lp["ln2"]["scale"].dtype == torch.float32
        if kind == "mla":
            assert lp["mla"]["wq_a"]["w"].dtype == torch.bfloat16
            assert lp["mla"]["q_norm"]["scale"].dtype == torch.float32
            assert lp["mla"]["kv_norm"]["scale"].dtype == torch.float32
        elif kind == "rglru":
            assert lp["rglru"]["lam"].dtype == torch.float32
            assert lp["rglru"]["conv"].dtype == torch.bfloat16
        else:
            assert lp["attn"]["wq"]["w"].dtype == torch.bfloat16
            assert ("b" in lp["attn"]["wq"]) == cfg.qkv_bias
            assert ("qnorm" in lp["attn"]) == cfg.qk_norm
        if kind == "attn_moe":
            assert lp["moe"]["router"].dtype == torch.float32
            assert lp["moe"]["wg"].dtype == torch.bfloat16
            assert lp["moe"]["wg"].shape == (cfg.n_experts, cfg.d_model,
                                             cfg.d_ff)
            assert ("shared" in lp["moe"]) == cfg.shared_expert
    n_body = cfg.n_groups * len(cfg.pattern)
    for li, (kind, lp) in enumerate(zip(pm.kinds, pm.layers)):
        if li < n_body:
            g, i = divmod(li, len(cfg.pattern))
            jl = jax.tree.map(lambda a: a[g], jp["groups"][f"b{i}"])
        else:
            jl = jp["tail"][li - n_body]
        want = dict(_leaves(jl))
        got = {tuple(n.split(".")): t for n, t in lp.named_parameters()}
        assert set(got) == set(want)
        for path, t in got.items():
            f32 = tT.leaf_is_f32(kind, path)
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16)
            w = np.asarray(want[path], np.float32)
            assert np.array_equal(t.float().numpy(), w if f32 else _bf16(w))
    assert not any(p.requires_grad for p in pm.parameters())


def test_forward_matches_jax(pair):
    name, jm, jp, pm, toks = pair
    (jt, je), (tt, te) = _feed(name, jp, pm, toks)
    with _ref_mode(pm.cfg):
        want, jaux = jm.forward(jp, jt, embeds=je)
    got, aux = pm(tt, embeds=te)
    assert got.dtype == torch.float32
    assert got.shape == (B, S, pm.cfg.vocab)
    if pm.cfg.n_experts:
        assert float(aux) > 0
        assert abs(float(aux) - float(jaux)) <= AUX_TOL * float(jaux)
    else:
        assert float(aux) == float(jaux) == 0.0
    assert _rel(got, want) <= _logit_tol(pm.cfg)


def test_decode_matches_jax(pair):
    """Six decode steps from an empty cache, both packages."""
    name, jm, jp, pm, toks = pair
    (jt, je), (tt, te) = _feed(name, jp, pm, toks)
    jc, tc = jm.init_cache(B, MAXLEN), pm.init_cache(B, MAXLEN)
    for t in range(6):
        with _ref_mode(pm.cfg):
            want, jc = jm.decode_step(jp, _at(jt, t), jc, embeds=_at(je, t))
        got, tc = pm.decode_step(_at(tt, t), tc, embeds=_at(te, t))
        assert got.shape == (B, 1, pm.cfg.vocab)
        assert _rel(got, want) <= _logit_tol(pm.cfg)
    assert tc["pos"] == int(jc["pos"]) == 6


def test_embeds_and_positions_match_jax(pair):
    """The stub-frontend input (embeds) and explicit positions; f32 embeds
    for F32_DRIVEN archs."""
    name, jm, jp, pm, toks = pair
    rng = np.random.default_rng(11)
    je, te = _pair(rng.normal(0, 1, (B, S, pm.cfg.d_model)),
                   "float32" if name in F32_DRIVEN else "bfloat16")
    pos = np.broadcast_to(np.arange(S) * 3 + 5, (B, S))
    with _ref_mode(pm.cfg):
        want, _ = jm.forward(jp, None, embeds=je, positions=jnp.asarray(pos))
    got, _ = pm(None, embeds=te, positions=torch.from_numpy(pos.copy()))
    assert _rel(got, want) <= _logit_tol(pm.cfg)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-350m",
                                  "qwen3-14b", "mixtral-8x7b",
                                  "whisper-base"])
def test_params_from_numpy_keeps_the_reference_f32_leaves(name):
    """The leaves the reference uses in f32 stay f32 through
    ``params_from_numpy``, exact (weights perturbed, so no leaf is a
    default): RG-LRU's ``lam``, the sLSTM's six gate matrices, the
    mLSTM's norm scale, the norms and the MoE router, whisper's ``ln3``
    and final layernorms. ``wi`` and ``wf`` of the mLSTM and ``wi`` of the
    GELU MLP, dense weights under the same names, are bf16. ``build``'s
    random weights take the same dtype at every leaf."""
    cfg = rcfg.get_reduced(name)
    rng = np.random.default_rng(40)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0, 0.01, np.shape(a)).astype(np.float32),
        jbuild(cfg).init(jax.random.PRNGKey(2)))
    pm = params_from_numpy(pcfg.get_reduced(name), tree, device="cpu")
    built = build(pcfg.get_reduced(name), device="cpu", seed=0)
    params = dict(pm.named_parameters())
    assert {k: v.dtype for k, v in params.items()} == {
        k: v.dtype for k, v in built.named_parameters()}
    f32 = {k for k, v in params.items() if v.dtype == torch.float32}
    expect = {
        "recurrentgemma-2b": ["layers.0.rglru.lam", "layers.7.rglru.lam",
                              "layers.2.ln2.scale", "final_norm.scale"],
        "xlstm-350m": ["layers.0.core.norm.scale"] + [
            f"layers.7.core.{g}.w" for g in ("wz", "rz", "wi", "ri", "wf",
                                             "rf")],
        "qwen3-14b": ["layers.0.attn.qnorm.scale", "layers.1.ln1.scale"],
        "mixtral-8x7b": ["layers.0.moe.router"],
        "whisper-base": ["dec.0.ln3.scale", "dec.1.ln3.bias",
                         "enc_norm.scale", "enc_norm.bias", "dec_norm.scale",
                         "enc.1.ln2.bias"]}[name]
    assert set(expect) <= f32
    assert all(k.split(".")[-1] in ("scale", "bias", "lam", "router", "w")
               for k in f32)
    bf16 = {"recurrentgemma-2b": ["layers.0.rglru.wi.w", "layers.0.mlp.wi",
                                  "layers.0.rglru.conv", "layers.2.mlp.wi"],
            "xlstm-350m": ["layers.0.core.wi.w", "layers.0.core.wf.w",
                           "layers.7.core.wo.w", "layers.7.core.ffn_up.w"],
            "qwen3-14b": ["layers.0.mlp.wg"],
            "mixtral-8x7b": ["layers.0.moe.wg"],
            "whisper-base": ["dec.0.mlp.wi", "enc.0.mlp.bi", "dec_pos",
                             "dec.0.cross.wq.w"]}[name]
    assert all(params[k].dtype == torch.bfloat16 for k in bf16)
    if name == "xlstm-350m":
        assert params["layers.7.core.wi.w"].dtype == torch.float32
        assert np.array_equal(params["layers.7.core.rf.w"].numpy(),
                              tree["groups"]["b7"]["core"]["rf"]["w"][0])
    if name == "recurrentgemma-2b":
        assert np.array_equal(params["layers.0.rglru.lam"].numpy(),
                              tree["groups"]["b0"]["rglru"]["lam"][0])
        # the tail's second block (layers 6, 7 follow two groups of three)
        assert np.array_equal(params["layers.7.rglru.lam"].numpy(),
                              tree["tail"][1]["rglru"]["lam"])


def test_mrope_three_stream_positions_match_jax():
    """qwen2-vl's vision stub: embeds for a 2 x 4 x 4 patch grid (temporal,
    height, width streams apart) followed by text, whose three streams
    coincide; positions (B, S, 3). MLA (minicpm3) takes the first stream
    of the same positions."""
    S_img = 32
    tt, hh, ww = np.meshgrid(np.arange(2), np.arange(4), np.arange(4),
                             indexing="ij")
    grid = np.stack([tt, hh, ww], -1).reshape(S_img, 3)
    # text resumes one past the grid's largest position, in all streams
    text = (4 + np.arange(8))[:, None].repeat(3, 1)
    pos = np.concatenate([grid, text])[None].repeat(B, 0)
    assert pos.shape == (B, S_img + 8, 3)
    assert not np.array_equal(pos[..., 1], pos[..., 2])
    for name in ("qwen2-vl-72b", "minicpm3-4b"):
        cfg = rcfg.get_reduced(name)
        jm = jbuild(cfg)
        rng = np.random.default_rng(12)
        tree = _perturb(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(4))), rng)
        pm = params_from_numpy(pcfg.get_reduced(name), tree, device="cpu")
        je, te = _pair(rng.normal(0, 1, (B, pos.shape[1], cfg.d_model)),
                       "bfloat16")
        want, _ = jm.forward(jax.tree.map(jnp.asarray, tree), None,
                             embeds=je, positions=jnp.asarray(pos))
        got, _ = pm(None, embeds=te, positions=torch.from_numpy(pos))
        assert _rel(got, want) <= LOGIT_TOL, name


def test_windowed_decode_past_the_wrap_matches_jax():
    """mixtral reduced (window 8): twelve decode steps through its ring
    caches of 8, so the last four overwrite the oldest entries, against
    the reference's decode (op by op; see the module docstring)."""
    name = "mixtral-8x7b"
    cfg = rcfg.get_reduced(name)
    assert cfg.window == 8
    jm = jbuild(cfg)
    rng = np.random.default_rng(13)
    tree = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5))),
                    rng)
    jp = jax.tree.map(jnp.asarray, tree)
    pm = params_from_numpy(pcfg.get_reduced(name), tree, device="cpu")
    toks = rng.integers(0, cfg.vocab, (B, 12)).astype(np.int32)
    jc, tc = jm.init_cache(B, MAXLEN), pm.init_cache(B, MAXLEN)
    assert tc["layers"][0].k.shape[1] == cfg.window
    for t in range(12):
        with jax.disable_jit():
            want, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        got, tc = pm.decode_step(torch.from_numpy(toks[:, t:t + 1]).long(),
                                 tc)
        assert tc["layers"][0].length == t + 1
        assert _rel(got, want) <= MOE_LOGIT_TOL


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


@pytest.mark.parametrize("name", rcfg.ARCH_NAMES)
def test_build_on_the_cpu(name):
    """Every arch builds, with the reference's parameter count (the JAX
    init's leaves, counted without allocating them) and, for the attention
    families, ``param_count()`` (which counts the matmul weights and the
    embedding, not the norm scales and biases; its recurrent and
    encoder-decoder terms are approximate); the same weights for the same
    seed; finite logits."""
    cfg = pcfg.get_reduced(name)
    model = build(cfg, device="cpu", seed=3)
    assert model.device == torch.device("cpu")
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(jbuild(rcfg.get_reduced(name)).init,
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    if cfg.enc_layers == 0:
        assert len(model.layers) == cfg.n_layers
    if set(cfg.pattern) <= {"attn", "attn_moe", "mla"} and not cfg.enc_layers:
        extra = sum(p.numel() for name_, p in model.named_parameters()
                    if name_.endswith(".scale") or name_.endswith(".b"))
        assert n - extra == cfg.param_count()
    again = build(cfg, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  again.parameters()))
    toks = torch.zeros((1, 8), dtype=torch.long)
    if cfg.enc_layers:
        lg, _ = model(toks, torch.zeros((1, 10, cfg.d_model),
                                        dtype=torch.bfloat16))
    else:
        lg, _ = model(toks)
    assert lg.shape == (1, 8, cfg.vocab) and bool(torch.isfinite(lg).all())


def test_unknown_block_kind_raises():
    cfg = pcfg.get_reduced("qwen3-14b")
    for fn in (lambda: tT.block_init(torch.Generator(), "conv", cfg),
               lambda: tT.block_cache_init("conv", cfg, 1, 8),
               lambda: tT.check_kind("conv")):
        with pytest.raises(ValueError):
            fn()
    for kind in tT.KINDS:
        tT.check_kind(kind)


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present, so the default does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        build(pcfg.get_reduced("qwen3-14b"))
