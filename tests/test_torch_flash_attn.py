"""The port's flash attention (K5) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch version; the JAX
wrappers run the Pallas kernel in interpret mode, as tests/test_flash_attn.py
runs it. Both compute in f32 and sum in different orders: the tolerance is
the JAX tests' own, 2e-5 for f32 and 2e-2 for bf16 (one bf16 rounding of
the output may fall the other way). The CUDA kernel itself is held against
the plain version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import flash_attn as jfa
from repro_torch.kernels import flash_attn as tfa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(rng, shape, dtype):
    """The same values in both packages: rounded to ``dtype`` once, by JAX."""
    j = jnp.asarray(rng.normal(0, 1, shape), getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,t,d,bq,bk", [
    (2, 128, 128, 32, 64, 64),
    (1, 96, 96, 16, 32, 32),
    (2, 128, 128, 64, 64, 32),
    (1, 64, 128, 32, 32, 64),
])
def test_flash_attention_matches_jax(dtype, causal, bh, s, t, d, bq, bk):
    rng = np.random.default_rng(bh * s + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (bh, n, d), dtype)
                                    for n in (s, t, t))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                               block_k=bk, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                              block_k=bk)
    assert got.dtype == tq.dtype and got.shape == (bh, s, d)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_matches_jax_ref(dtype, causal):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (3, 40, 24), dtype)
                                    for _ in range(3))
    want = jfa.flash_attention_ref(jq, jk, jv, causal=causal, scale=0.3)
    got = tfa.flash_attention_ref(tq, tk, tv, causal=causal, scale=0.3)
    assert got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


@settings(max_examples=6, deadline=None)
@given(b=st.integers(1, 2), s=st.sampled_from([40, 96, 100]),
       h=st.sampled_from([2, 4]), kv=st.sampled_from([1, 2]),
       hd=st.sampled_from([16, 32]))
def test_flash_mha_matches_jax(b, s, h, kv, hd):
    """GQA with S padded to the block grid (96 is a multiple of 32; 40 and
    100 are not)."""
    rng = np.random.default_rng(b * s * h + kv)
    jq, tq = _pair(rng, (b, s, h, hd), "float32")
    jk, tk = _pair(rng, (b, s, kv, hd), "float32")
    jv, tv = _pair(rng, (b, s, kv, hd), "float32")
    want = jfa.flash_mha(jq, jk, jv, block_q=32, block_k=32, interpret=True)
    got = tfa.flash_mha(tq, tk, tv, block_q=32, block_k=32)
    assert got.shape == (b, s, h * hd)
    _close(got, want, 3e-5)


def test_flash_mha_bf16_matches_jax():
    rng = np.random.default_rng(8)
    jq, tq = _pair(rng, (1, 70, 4, 32), "bfloat16")
    jk, tk = _pair(rng, (1, 70, 1, 32), "bfloat16")
    jv, tv = _pair(rng, (1, 70, 1, 32), "bfloat16")
    want = jfa.flash_mha(jq, jk, jv, block_q=32, block_k=32, interpret=True)
    got = tfa.flash_mha(tq, tk, tv, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


def _bf16_tensor_core_plain(q, k, v, *, causal, block_k=64):
    """K5-bf16's numerics, key tile by key tile: f32 scores from the bf16
    inputs, the online (m, l, acc) in f32 with l summed from the f32 p, and
    only the value product's operand p rounded to bf16; the output rounded
    to bf16."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    bh, s, d = q.shape
    t = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, t, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        sc = torch.einsum("bsd,btd->bst", qf, kt) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
            sc = sc.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + torch.einsum(
            "bst,btd->bsd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_tensor_core_numerics_match_jax(causal):
    """The CUDA kernel's bf16 design (P rounded to bf16 before P V) stays
    within the bf16 tolerance of the JAX kernel, which keeps P in f32."""
    rng = np.random.default_rng(13)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, 256, 128), "bfloat16")
                                    for _ in range(3))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=128,
                               block_k=128, interpret=True)
    got = _bf16_tensor_core_plain(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


def test_flash_attention_keeps_the_block_checks():
    q = torch.zeros((1, 96, 16))
    with pytest.raises(ValueError, match="block_q"):
        tfa.flash_attention(q, q, q, block_q=64, block_k=32)
    with pytest.raises(ValueError, match="block_k"):
        tfa.flash_attention(q, torch.zeros((1, 80, 16)),
                            torch.zeros((1, 80, 16)), block_q=32, block_k=64)


@pytest.mark.parametrize("d", [0, tfa.MAX_HEAD_DIM + 1])
def test_flash_attention_refuses_a_head_dim_out_of_range(d):
    q = torch.zeros((1, 32, d))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q, block_q=32, block_k=32)


def test_flash_attention_refuses_mixed_or_integer_dtypes():
    q = torch.zeros((1, 32, 16))
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention(q, q.to(torch.bfloat16), q, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention(*(q.to(torch.int8),) * 3, block_q=32, block_k=32)


# -- the window (sliding-window attention, on the causal mask) ---------------

def _heads(x):
    """(BH, S, d) -> (1, S, BH, d): the reference's attention layout, one
    KV head a query head."""
    return x.transpose(0, 1)[None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window", [(40, 1), (40, 8), (96, 63), (96, 64),
                                      (100, 100), (70, 500)])
def test_windowed_flash_attention_matches_jax_mask(dtype, s, window):
    """The window against the reference's own mask,
    ``_sdpa(q, k, v, _causal_mask(S, S, window))``
    (src/repro/models/attention.py:116-123), windows 1 to beyond S. The
    reference's ``_sdpa`` rounds the softmax weights to v's dtype before
    the second product; in f32 that is no rounding, in bf16 one ulp (the
    tolerance of the JAX kernel tests, as above)."""
    from repro.models import attention as jA
    rng = np.random.default_rng(s + window)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (3, s, 16), dtype)
                                    for _ in range(3))
    want = jA._sdpa(*(jnp.moveaxis(a, 0, 1)[None] for a in (jq, jk, jv)),
                    jA._causal_mask(s, s, window), 1)
    want = np.asarray(want.astype(jnp.float32)).reshape(s, 3, 16)
    got = tfa.flash_attention(tq, tk, tv, causal=True, window=window,
                              block_q=s, block_k=s)
    assert got.dtype == tq.dtype
    _close(_heads(got)[0], want, TOL[dtype])
    ref = tfa.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert torch.equal(got, ref)


def test_windowed_flash_mha_matches_jax_attention_mask():
    """GQA (4 query heads on 2 KV heads) with a window, S off the block
    grid: flash_mha against the reference's ``_sdpa`` with its mask."""
    from repro.models import attention as jA
    rng = np.random.default_rng(9)
    jq, tq = _pair(rng, (2, 70, 4, 16), "float32")
    jk, tk = _pair(rng, (2, 70, 2, 16), "float32")
    jv, tv = _pair(rng, (2, 70, 2, 16), "float32")
    want = jA._sdpa(jq, jk, jv, jA._causal_mask(70, 70, 20), 2)
    got = tfa.flash_mha(tq, tk, tv, block_q=32, block_k=32, window=20)
    assert got.shape == (2, 70, 64)
    _close(got, want, 3e-5)
    wide = tfa.flash_mha(tq, tk, tv, block_q=32, block_k=32, window=70)
    assert torch.equal(wide, tfa.flash_mha(tq, tk, tv, block_q=32,
                                           block_k=32))


def test_a_row_that_sees_no_key_gives_zero_as_the_chunked_scan():
    """S > T + window: query rows 4.. see no key. The reference's chunked
    flash scan weighs a hidden key exactly 0 (``jnp.where(ok, ..., 0)``)
    and so gives 0 there; the plain version does the same."""
    from repro.models import attention as jA
    rng = np.random.default_rng(10)
    jq, tq = _pair(rng, (1, 8, 1, 16), "float32")
    jk, tk = _pair(rng, (1, 2, 1, 16), "float32")
    jv, tv = _pair(rng, (1, 2, 1, 16), "float32")
    want = jA._sdpa_q_chunked(jq, jk, jv, 3, 1, 8)
    got = tfa.flash_attention_ref(tq[0].transpose(0, 1), tk[0].transpose(0, 1),
                                  tv[0].transpose(0, 1), window=3)
    assert np.asarray(want)[0, :4].all(axis=-1).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0],
                               rtol=2e-5, atol=2e-5)
    assert not got[0, 4:].any()


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_ref",
                                "flash_mha"])
def test_window_refused_without_the_causal_mask_or_below_one(fn):
    q = torch.zeros((1, 32, 16))
    call = {"flash_attention": lambda **kw: tfa.flash_attention(
                q, q, q, block_q=32, block_k=32, **kw),
            "flash_attention_ref": lambda **kw: tfa.flash_attention_ref(
                q, q, q, **kw),
            "flash_mha": lambda **kw: tfa.flash_mha(
                q[None], q[None], q[None], block_q=32, block_k=32,
                **{k: v for k, v in kw.items() if k != "causal"})}[fn]
    for w in (0, -3):
        with pytest.raises(ValueError, match="at least 1"):
            call(window=w)
    if fn != "flash_mha":
        with pytest.raises(ValueError, match="causal"):
            call(window=4, causal=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [tfa.ref.Q_BLOCK, 100])
@pytest.mark.parametrize("causal,window,t", [(True, None, 1100),
                                             (True, 100, 1100),
                                             (False, None, 1500)],
                         ids=["causal", "window", "no-mask"])
def test_plain_version_in_query_blocks_equals_one_block(monkeypatch, dtype,
                                                        block, causal, window,
                                                        t):
    """K5's plain version takes q's rows in blocks (at most Q_BLOCK, the
    reference scan's query chunk), each against every key with one
    softmax over the whole row: at S = 1100 (not a multiple of 512, so
    the last block is ragged) it equals the one-block version (Q_BLOCK =
    S) bit for bit, causal with and without a window and without the mask
    at T != S."""
    rng = np.random.default_rng(11)
    s = 1100
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (3, n, 16))).to(
        getattr(torch, dtype)) for n in (s, t, t))
    kw = dict(causal=causal, window=window)
    monkeypatch.setattr(tfa.ref, "Q_BLOCK", block)
    got = tfa.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    monkeypatch.setattr(tfa.ref, "Q_BLOCK", s)
    assert torch.equal(got, tfa.flash_attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_holds_one_query_block_of_scores(causal):
    """On fake tensors (as the dry run calls it): every (s, t) pair is
    computed (4·BH·S·T·d FLOPs, the reference scan's dense count), no
    storage live at the peak is larger than one (BH, Q_BLOCK, T) f32
    block of scores, where the one-block version held (BH, S, T), and the
    temporaries (that block, its mask, k, v and the output) stay below two
    such blocks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo_analysis import OpCounter
    bh, s, d = 4, 2048 + 100, 64
    with FakeTensorMode():
        q = torch.zeros((bh, s, d), dtype=torch.bfloat16)
        with OpCounter(at_peak=True) as c:
            c.track(q)
            tfa.flash_attention_ref(q, q, q, causal=causal)
            peak = c.at_peak(1)
    assert c.flops == 4 * bh * s * s * d
    assert peak["largest"][0]["bytes"] <= 4 * bh * tfa.ref.Q_BLOCK * s
    assert c.peak - 2 * q.numel() < 2 * 4 * bh * tfa.ref.Q_BLOCK * s
