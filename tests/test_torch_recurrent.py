"""The port's recurrent blocks (``repro_torch.models.recurrent``: RG-LRU,
mLSTM, sLSTM) against the JAX package's, on the CPU, at small sizes.

The same numpy-seeded inputs and the JAX init's own weights go through
both, in f32 and in bf16. None of these blocks is a Pallas kernel in the
reference, so nothing runs in interpret mode here.

Tolerances, and why:
  * f32: F32_TOL = 2e-5 (rtol = atol). The RG-LRU scan composes the
    recurrence in another tree than ``jax.lax.associative_scan`` and the
    sLSTM forms x_t @ w for the whole sequence before its loop: f32 sums
    in another order, a few ulps of outputs of order 1.
  * bf16: BF16_TOL = 2e-2 (rtol = atol). Both sides round each bf16
    intermediate (the projections, the GELU, the depthwise conv's four
    products and sums, the output) to bf16, 2^-8 relative apart; XLA may
    keep a fused elementwise chain in f32 where torch rounds each op (the
    conv's sum), so an output may sit a few ulps away.
  * A step form against its own sequence form (the port's): the same
    tolerances, since the two compose the recurrence in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro.models import build as jbuild
from repro.models import recurrent as jR
from repro.models import transformer as jT
from repro_torch import configs as pcfg
from repro_torch.models import params_from_numpy
from repro_torch.models import recurrent as tR
from repro_torch.models import transformer as tT

F32_TOL, BF16_TOL = 2e-5, 2e-2
LOGIT_TOL = 0.02
D = 64


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request):
    return request.param


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


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


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape and np.isfinite(g).all()
    return float(np.abs(g - w).max() / np.abs(w).max())


def _weights(init, cfg, seed=1):
    """The JAX init's weights as numpy, and as f32 tensors (dtype casts are
    the block's own, from x's dtype)."""
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                         p))


def _x(dtype, s, seed=0, b=2):
    return _pair(np.random.default_rng(seed).normal(0, 1, (b, s, D)), dtype)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_rglru_lam_equals_the_reference_init():
    """The deterministic softplus^-1 init of ``lam``, f32, at the full width
    (2560) and a reduced one."""
    for w in (D, 2560):
        want = np.asarray(jR.rglru_init(jax.random.PRNGKey(0),
                                        jR.RGLRUConfig(d_model=w))["lam"])
        got = tR.rglru_lam(w)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=0)
    p = tR.rglru_init(torch.Generator().manual_seed(0),
                      tR.RGLRUConfig(d_model=D), dtype=torch.bfloat16)
    assert p["lam"].dtype == torch.float32
    assert p["wa"]["w"].dtype == p["conv"].dtype == torch.bfloat16


def test_causal_depthwise_conv_matches_jax(dtype):
    """The width-4 conv, from zeros and from a state prefix. In bf16 the
    reference sums four bf16 products in bf16; the port rounds each term
    and sum alike, within BF16_TOL."""
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.normal(0, 1, (2, 9, D)), dtype)
    jk, tk = _pair(rng.normal(0, 0.3, (4, D)), "float32")
    jp, tp = _pair(rng.normal(0, 1, (2, 3, D)), dtype)
    for pre in (None, (jp, tp)):
        want = jR._causal_depthwise_conv(jx, jk, None if pre is None
                                         else pre[0])
        got = tR._causal_depthwise_conv(tx, tk, None if pre is None
                                        else pre[1])
        assert got.dtype == tx.dtype
        _close(got, want, _tol(dtype))


@pytest.mark.parametrize("s", [1, 2, 3, 8, 37, 64])
def test_linear_scan_equals_the_sequential_recurrence(s):
    """h_t = a_t h_{t-1} + b_t, the doubling scan against a loop, at
    lengths on and off a power of two."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (2, s, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(tR.linear_scan(a, b), torch.stack(want, 1), F32_TOL)


def test_rglru_block_matches_jax(dtype):
    """S = 37: odd and not a power of two, so the doubling scan's last,
    partial step counts."""
    cfg = jR.RGLRUConfig(d_model=D)
    jp, tp = _weights(jR.rglru_init, cfg)
    jx, tx = _x(dtype, 37)
    want = jR.rglru_block(jp, jx, cfg)
    got = tR.rglru_block(tp, tx, tR.RGLRUConfig(d_model=D))
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    _close(got, want, _tol(dtype))


def test_rglru_step_matches_jax_and_the_block(dtype):
    """Twelve steps from the empty state: each output and state equals the
    JAX step's, and the outputs equal the port's own sequence form."""
    cfg = jR.RGLRUConfig(d_model=D)
    tcfg = tR.RGLRUConfig(d_model=D)
    jp, tp = _weights(jR.rglru_init, cfg)
    jx, tx = _x(dtype, 12, seed=1)
    jst = jR.rglru_init_state(cfg, 2, dtype=getattr(jnp, dtype))
    tst = tR.rglru_init_state(tcfg, 2, dtype=getattr(torch, dtype))
    assert tst.h.dtype == torch.float32 and tst.conv.shape == jst.conv.shape
    outs = []
    for t in range(12):
        want, jst = jR.rglru_step(jp, jx[:, t:t + 1], jst, cfg)
        got, tst = tR.rglru_step(tp, tx[:, t:t + 1], tst, tcfg)
        assert tst.h.dtype == torch.float32
        assert tst.conv.dtype == getattr(torch, dtype)
        _close(got, want, _tol(dtype))
        _close(tst.h, jst.h, _tol(dtype))
        _close(tst.conv, jst.conv, _tol(dtype))
        outs.append(got)
    _close(torch.cat(outs, 1), tR.rglru_block(tp, tx, tcfg), _tol(dtype))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

MCFG = dict(d_model=D, n_heads=2, chunk=8)


def test_mlstm_block_matches_jax(dtype):
    """S = 32 at chunk 8: four chunks, the matrix memory carried across."""
    cfg = jR.MLSTMConfig(**MCFG)
    jp, tp = _weights(jR.mlstm_init, cfg)
    jx, tx = _x(dtype, 32, seed=2)
    want = jR.mlstm_block(jp, jx, cfg)
    got = tR.mlstm_block(tp, tx, tR.MLSTMConfig(**MCFG))
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    _close(got, want, _tol(dtype))


def test_mlstm_block_refuses_a_ragged_sequence():
    tp = _weights(jR.mlstm_init, jR.MLSTMConfig(**MCFG))[1]
    with pytest.raises(ValueError, match="chunk"):
        tR.mlstm_block(tp, torch.zeros((1, 12, D)), tR.MLSTMConfig(**MCFG))


def test_mlstm_step_matches_jax_and_the_chunkwise_form(dtype):
    """32 steps from the empty state against the JAX step (output and
    both memories) and against the port's chunkwise form."""
    cfg = jR.MLSTMConfig(**MCFG)
    tcfg = tR.MLSTMConfig(**MCFG)
    jp, tp = _weights(jR.mlstm_init, cfg)
    jx, tx = _x(dtype, 32, seed=4)
    jst = jR.mlstm_init_state(cfg, 2)
    tst = tR.mlstm_init_state(tcfg, 2)
    assert tst.S.shape == jst.S.shape and tst.S.dtype == torch.float32
    outs = []
    for t in range(32):
        want, jst = jR.mlstm_step(jp, jx[:, t:t + 1], jst, cfg)
        got, tst = tR.mlstm_step(tp, tx[:, t:t + 1], tst, tcfg)
        _close(got, want, _tol(dtype))
        _close(tst.S, jst.S, _tol(dtype))
        _close(tst.n, jst.n, _tol(dtype))
        outs.append(got)
    _close(torch.cat(outs, 1), tR.mlstm_block(tp, tx, tcfg), _tol(dtype))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

SCFG = dict(d_model=D, n_heads=2)


def test_slstm_init_keeps_the_gates_f32():
    """The six gate matrices the reference casts to f32 at every step are
    f32; ``wo`` and the FFN (whose keys the reference draws with fold_in)
    take the weight dtype."""
    p = tR.slstm_init(torch.Generator().manual_seed(0),
                      tR.SLSTMConfig(**SCFG), dtype=torch.bfloat16)
    for g in ("wz", "rz", "wi", "ri", "wf", "rf"):
        assert p[g]["w"].dtype == torch.float32 and p[g]["w"].shape == (D, D)
    assert p["wo"]["w"].dtype == torch.bfloat16
    jp = jR.slstm_init(jax.random.PRNGKey(0), jR.SLSTMConfig(**SCFG))
    assert ({k: tuple(v["w"].shape) for k, v in p.items()}
            == {k: tuple(v["w"].shape) for k, v in jp.items()})


def test_slstm_block_matches_jax(dtype):
    cfg = jR.SLSTMConfig(**SCFG)
    jp, tp = _weights(jR.slstm_init, cfg)
    jx, tx = _x(dtype, 24, seed=5)
    want = jR.slstm_block(jp, jx, cfg)
    got = tR.slstm_block(tp, tx, tR.SLSTMConfig(**SCFG))
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    _close(got, want, _tol(dtype))


def test_slstm_step_matches_jax_and_the_block(dtype):
    cfg = jR.SLSTMConfig(**SCFG)
    tcfg = tR.SLSTMConfig(**SCFG)
    jp, tp = _weights(jR.slstm_init, cfg)
    jx, tx = _x(dtype, 24, seed=6)
    jst, tst = jR.slstm_init_state(cfg, 2), tR.slstm_init_state(tcfg, 2)
    outs = []
    for t in range(24):
        want, jst = jR.slstm_step(jp, jx[:, t:t + 1], jst, cfg)
        got, tst = tR.slstm_step(tp, tx[:, t:t + 1], tst, tcfg)
        _close(got, want, _tol(dtype))
        for a, b in zip(tst, jst):
            assert a.dtype == torch.float32
            _close(a, b, _tol(dtype))
        outs.append(got)
    _close(torch.cat(outs, 1), tR.slstm_block(tp, tx, tcfg), _tol(dtype))


# ---------------------------------------------------------------------------
# the blocks inside the model, bf16 as served
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["xlstm-350m", "recurrentgemma-2b"])
def test_each_model_block_matches_jax_on_the_references_input(name):
    """Every block of the reduced model (``transformer.block_apply``, the
    residual and the norms included), in bf16 with the weights as
    ``params_from_numpy`` holds them, fed the reference's own output of
    the block before: within LOGIT_TOL of the largest value. (Chained
    through xlstm's 16 blocks, one bf16 ulp a block grows about 30-fold;
    tests/test_torch_lm.py says how the whole model is held.) Then one
    decode step of each block (``block_decode``) from its empty state."""
    cfg = rcfg.get_reduced(name)
    jm = jbuild(cfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    pm = params_from_numpy(pcfg.get_reduced(name), tree, device="cpu")
    jx, _ = _x("bfloat16", 16, seed=7)
    jx = jx * 2
    kinds = pm.kinds
    n_body = cfg.n_groups * len(cfg.pattern)
    for li, (kind, tp) in enumerate(zip(kinds, pm.layers)):
        if li < n_body:
            g, i = divmod(li, len(cfg.pattern))
            jl = jax.tree.map(lambda a: a[g], jp["groups"][f"b{i}"])
        else:
            jl = jp["tail"][li - n_body]
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            torch.bfloat16)
        jc = jT.block_cache_init(kind, cfg, 2, 8)
        tc = tT.block_cache_init(kind, pm.cfg, 2, 8)
        want_d, _, _ = jT.block_decode(kind, jl, jx[:, :1], jc, cfg)
        got_d, _, _ = tT.block_decode(kind, tp, tx[:, :1], tc, pm.cfg)
        assert _rel(got_d, want_d) <= LOGIT_TOL, (li, kind, "decode")
        jx, _ = jT.block_apply(kind, jl, jx, cfg, None)
        got, aux = tT.block_apply(kind, tp, tx, pm.cfg, None)
        assert float(aux) == 0.0 and got.dtype == torch.bfloat16
        assert _rel(got, jx) <= LOGIT_TOL, (li, kind)
