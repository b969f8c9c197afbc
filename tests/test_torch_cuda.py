"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc: it is marked ``cuda`` and
skips where there is none. On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

The file imports no JAX, so it runs where only PyTorch is installed.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, launches
from repro_torch.kernels import cascade_mlp as tcm
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import global_agg as tga
from repro_torch.kernels import mm_int8 as tmm
from repro_torch.quant import QuantizedLinear, QuantizedMLP, quantize_mlp
from repro_torch.serve import JetServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int8(rng, shape, dev, lo=-128, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)).to(dev)


def _qmlp(rng, dims, relu_last=False):
    ws = [rng.normal(0, 0.4, (dims[i], dims[i + 1])) for i in range(len(dims) - 1)]
    bs = [rng.normal(0, 0.1, (d,)) for d in dims[1:]]
    relus = [True] * (len(ws) - 1) + [relu_last]
    return quantize_mlp(ws, bs, relus, rng.normal(0, 1, (64, dims[0])))


def _deepsets(rng, f, phi_nodes, rho_nodes):
    return (_qmlp(rng, [f] + phi_nodes, relu_last=True),
            _qmlp(rng, [phi_nodes[-1]] + rho_nodes))


@pytest.mark.parametrize("m,k,n", list(itertools.product([1, 7, 100, 4096],
                                                         [5, 21, 130],
                                                         [5, 64, 200])))
def test_mm_int8_equals_plain(dev, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, w = _int8(rng, (m, k), dev), _int8(rng, (k, n), dev)
    b = torch.from_numpy(rng.integers(-5000, 5000, n).astype(np.int32)).to(dev)
    for kw in (dict(shift=7, relu=True), dict(shift=0), dict(out_int8=False),
               dict(shift=30)):
        assert torch.equal(tmm.mm_int8(x, w, b, **kw),
                           tmm.mm_int8_ref(x, w, b, **kw))
        assert torch.equal(tmm.mm_int8(x, w, **kw), tmm.mm_int8_ref(x, w, **kw))


@pytest.mark.parametrize("m,k,n", list(itertools.product([16, 4096],
                                                         [16, 32, 64, 128],
                                                         [5, 32, 64, 200])))
def test_mm_int8_aligned_rows_equal_plain(dev, m, k, n):
    """K a multiple of 16 on a fresh tensor: the kernel's 16-byte staging."""
    rng = np.random.default_rng(m + 3 * k + n)
    x, w = _int8(rng, (m, k), dev), _int8(rng, (k, n), dev)
    b = torch.from_numpy(rng.integers(-5000, 5000, n).astype(np.int32)).to(dev)
    assert x.data_ptr() % 16 == 0
    for kw in (dict(shift=5, relu=True), dict(out_int8=False)):
        assert torch.equal(tmm.mm_int8(x, w, b, **kw),
                           tmm.mm_int8_ref(x, w, b, **kw))


def test_mm_int8_takes_a_misaligned_view(dev):
    """K = 32 but x starts one byte past an alignment: the masked path."""
    rng = np.random.default_rng(9)
    x = _int8(rng, (1 + 100 * 32,), dev)[1:].view(100, 32)
    w = _int8(rng, (32, 64), dev)
    assert x.data_ptr() % 16
    for kw in (dict(shift=4, relu=True), dict(out_int8=False)):
        assert torch.equal(tmm.mm_int8(x, w, **kw), tmm.mm_int8_ref(x, w, **kw))


def test_mm_int8_saturates(dev):
    x = torch.full((8, 128), 127, dtype=torch.int8, device=dev)
    w = torch.full((128, 8), 127, dtype=torch.int8, device=dev)
    out = tmm.mm_int8(x, w)
    assert int(out.max()) == 127 and int(out.min()) == 127


# Past 2^31 the int32 accumulator wraps, as the JAX reference's int32 dot
# does: (x, w, K, out_int8, the JAX mm_int8_ref's result).
WRAP_CASES = [(-128, -128, 131_073, False, -2147467264),
              (-128, 127, 132_200, True, 127)]


@pytest.mark.parametrize("xv,wv,k,out_int8,want", WRAP_CASES)
def test_mm_int8_wraps_as_the_reference(dev, xv, wv, k, out_int8, want):
    x = torch.full((1, k), xv, dtype=torch.int8, device=dev)
    w = torch.full((k, 1), wv, dtype=torch.int8, device=dev)
    got = tmm.mm_int8(x, w, out_int8=out_int8)
    plain = tmm.mm_int8_ref(x, w, out_int8=out_int8)
    assert torch.equal(got, plain)
    assert int(got.item()) == want


def test_h100_model_constants_are_current(dev):
    """Each measured constant of the H100 model within 2x of what this card
    measures now, so that a stale constant is caught."""
    from repro_torch.core import h100_model
    now = h100_model.calibrate(dev)["constants"]
    for name in h100_model.MEASURED:
        held = getattr(h100_model, name)
        assert 0.5 <= held / now[name] <= 2.0, (name, held, now[name])


CHAINS = [[16, 64, 32, 32, 32, 5], [16, 128, 64, 64, 64, 5], [21, 32, 5],
          [32, 128, 64, 5], [64, 32, 128, 32, 5],
          [512, 256, 5]]                       # above 48 KB of shared memory


@pytest.mark.parametrize("dims", CHAINS, ids=lambda d: "-".join(map(str, d)))
def test_cascade_mlp_and_unfused_equal_plain(dev, dims):
    rng = np.random.default_rng(len(dims))
    q = _qmlp(rng, dims).to(dev)
    for rows in (1, 63, 64, 65, 4096):
        x = _int8(rng, (rows, dims[0]), dev)
        want = tcm.cascade_mlp_ref(x, q)
        assert torch.equal(tcm.cascade_mlp(x, q), want)
        assert torch.equal(tcm.mlp_unfused(x, q), want)


def test_cascade_mlp_refuses_a_chain_above_one_block(dev):
    q = _qmlp(np.random.default_rng(0), [1024, 256, 5]).to(dev)
    x = torch.zeros((4, 1024), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="cannot be fused"):
        tcm.cascade_mlp(x, q)


def _int8_chain(rng, dims, *, shift=7, no_bias=()):
    """Random int8 weights and int32 biases (none for the layers in
    ``no_bias``), ReLU between layers and none after the last."""
    layers = []
    for i in range(len(dims) - 1):
        w = torch.from_numpy(rng.integers(-128, 128, (dims[i], dims[i + 1]))
                             .astype(np.int8))
        b = None if i in no_bias else torch.from_numpy(
            rng.integers(-20000, 20000, dims[i + 1]).astype(np.int32))
        layers.append(QuantizedLinear(w, b, shift, i < len(dims) - 2, 0, 0))
    return QuantizedMLP(0, tuple(layers))


# Chains that reach every branch of the tensor-core K2 kernel: K0 off and on
# the 16-byte x path, widths that are no multiple of 8 or 32 mid-chain, the
# 16 layers MAX_LAYERS allows, layers without bias, and shifts 0 and 30.
K2_CHAINS = {
    "k0-5": ([5, 64, 32, 5], 7, ()),
    "k0-16": ([16, 64, 32, 32, 32, 5], 7, ()),
    "k0-21": ([21, 32, 5], 7, ()),
    "k0-32": ([32, 128, 64, 5], 7, ()),
    "k0-130": ([130, 200, 64, 10], 9, ()),
    "odd-n-mid-chain": ([16, 20, 13, 37, 70, 5], 6, ()),
    "16-layers": ([21, 40, 24, 64, 8, 33, 16, 48, 96, 12, 32, 72, 20, 64,
                   36, 16, 5], 7, ()),
    "one-layer-without-bias": ([16, 64, 32, 32, 5], 7, (1,)),
    "no-bias": ([16, 64, 5], 8, (0, 1)),
    "shift-0": ([16, 64, 32, 5], 0, ()),
    "shift-30": ([16, 64, 32, 5], 30, ()),
}


@pytest.mark.parametrize("name", list(K2_CHAINS))
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 31, 33, 4097])
def test_cascade_mlp_tensor_core_branches_equal_plain(dev, name, rows):
    dims, shift, no_bias = K2_CHAINS[name]
    rng = np.random.default_rng(rows + len(dims))
    q = _int8_chain(rng, dims, shift=shift, no_bias=no_bias).to(dev)
    x = _int8(rng, (rows, dims[0]), dev)
    assert torch.equal(tcm.cascade_mlp(x, q), tcm.cascade_mlp_ref(x, q))


@pytest.mark.parametrize("k0", [16, 32])
def test_cascade_mlp_takes_a_misaligned_view(dev, k0):
    """K0 a multiple of 16 but x starts one byte past an alignment: the
    byte path of the x staging."""
    rng = np.random.default_rng(12)
    q = _int8_chain(rng, [k0, 64, 32, 5])
    x = _int8(rng, (1 + 100 * k0,), dev)[1:].view(100, k0)
    assert x.data_ptr() % 16
    q = q.to(dev)
    assert torch.equal(tcm.cascade_mlp(x, q), tcm.cascade_mlp_ref(x, q))


def test_cascade_mlp_saturates(dev):
    """All 127: every sum is 127*127*K, far above int8, at every layer."""
    layers = tuple(QuantizedLinear(
        torch.full((k, n), 127, dtype=torch.int8),
        torch.full((n,), 127, dtype=torch.int32), 0, True, 0, 0)
        for k, n in ((128, 64), (64, 8)))
    q = QuantizedMLP(0, layers).to(dev)
    x = torch.full((40, 128), 127, dtype=torch.int8, device=dev)
    out = tcm.cascade_mlp(x, q)
    assert torch.equal(out, tcm.cascade_mlp_ref(x, q))
    assert int(out.min()) == 127


# phi and rho widths: the served deepsets-32 and deepsets-64, and a chain
# with widths that are no multiple of 8 and a phi layer without bias.
DEEPSETS = {"deepsets-32": ([32, 32, 32], [32, 10], ()),
            "deepsets-64": ([64, 64, 64], [64, 10], ()),
            "odd-widths": ([20, 13, 37], [10], (1,))}


@pytest.mark.parametrize("model", list(DEEPSETS))
@pytest.mark.parametrize("m,agg", [(1, "mean"), (7, "mean"), (32, "sum"),
                                   (64, "mean"), (200, "sum")])
def test_deepsets_equals_plain(dev, model, m, agg):
    phi_nodes, rho_nodes, no_bias = DEEPSETS[model]
    rng = np.random.default_rng(m)
    phi, rho = _deepsets(rng, 21, phi_nodes, rho_nodes)
    phi = dataclasses.replace(phi, layers=tuple(
        dataclasses.replace(l, bias_q=None) if i in no_bias else l
        for i, l in enumerate(phi.layers)))
    phi, rho = phi.to(dev), rho.to(dev)
    mp = 1 << (m - 1).bit_length()
    for batch in (1, 64, 65):
        x = _int8(rng, (batch, m, 21), dev, -40, 40)
        want = tcm.deepsets_ref(F.pad(x, (0, 0, 0, mp - m)), phi, rho, agg=agg)
        assert torch.equal(tcm.deepsets(x, phi, rho, agg=agg), want)
    assert torch.equal(tcm.deepsets(x[0], phi, rho, agg=agg), want[0])


@pytest.mark.parametrize("m", [32, 33])
def test_deepsets_takes_a_misaligned_view(dev, m):
    """x starts one byte past an alignment: the byte path of the x staging
    (at m = 33 also across two 32-row passes)."""
    rng = np.random.default_rng(15)
    phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
    phi, rho = phi.to(dev), rho.to(dev)
    x = _int8(rng, (1 + 5 * m * 21,), dev, -40, 40)[1:].view(5, m, 21)
    assert x.data_ptr() % 16
    mp = 1 << (m - 1).bit_length()
    want = tcm.deepsets_ref(F.pad(x, (0, 0, 0, mp - m)), phi, rho)
    assert torch.equal(tcm.deepsets(x, phi, rho), want)


def test_each_wrapper_counts_its_launches(dev):
    rng = np.random.default_rng(1)
    q = _qmlp(rng, [16, 32, 5]).to(dev)
    phi, rho = _deepsets(rng, 21, [32, 32], [10])
    phi, rho = phi.to(dev), rho.to(dev)
    launches.reset()
    tcm.cascade_mlp(_int8(rng, (70, 16), dev), q)
    tcm.mlp_unfused(_int8(rng, (70, 16), dev), q)
    tcm.deepsets(_int8(rng, (3, 32, 21), dev, -40, 40), phi, rho)
    x = _int8(rng, (64, 64), dev)
    tga.global_agg(x, op="mean", impl="mac")
    tga.global_agg(x, impl="extract_add")
    tga.global_agg(x, impl="extract_add")
    a = torch.zeros((1, 64, 4, 32), device=dev)
    tfa.flash_mha(a, a[:, :, :1], a[:, :, :1], block_q=64, block_k=64)
    assert launches.snapshot() == {"cascade_mlp": 1, "mm_int8": 2,
                                   "deepsets": 1, "global_agg_mac": 1,
                                   "global_agg_extract_add": 2,
                                   "flash_attn": 1}
    tcm.cascade_mlp(torch.zeros((5, 16), dtype=torch.int8), q.to("cpu"))
    assert launches.get("cascade_mlp") == 1     # the plain version counts nothing


@pytest.mark.parametrize("m", [1, 3, 4, 7, 32, 64, 100, 4096])
@pytest.mark.parametrize("f", [5, 64, 130, 1000])
def test_global_agg_equals_plain(dev, m, f):
    rng = np.random.default_rng(m * 7 + f)
    x = _int8(rng, (m, f), dev)
    for op in ("sum", "mean"):
        mp = 1 << (m - 1).bit_length() if op == "mean" else m
        want = tga.global_agg_ref(F.pad(x, (0, 0, 0, mp - m)), op=op)
        for impl in ("mac", "extract_add"):
            assert torch.equal(tga.global_agg(x, op=op, impl=impl), want)


@pytest.mark.parametrize("cols", [(8, 40), (3, 67), (0, 64), (4, 5)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("m", [1, 7, 64, 100])
def test_global_agg_takes_a_column_slice(dev, cols, m):
    """Columns of a wider matrix: the row stride (160) is not F, and the
    slice starts on a word (8, 0, 4) or off one (3)."""
    rng = np.random.default_rng(m + cols[0])
    x = _int8(rng, (m, 160), dev)[:, cols[0]:cols[1]]
    assert x.stride(0) == 160 and x.stride(1) == 1
    for op in ("sum", "mean"):
        mp = 1 << (m - 1).bit_length() if op == "mean" else m
        want = tga.global_agg_ref(F.pad(x, (0, 0, 0, mp - m)), op=op)
        for impl in ("mac", "extract_add"):
            assert torch.equal(tga.global_agg(x, op=op, impl=impl), want)


def test_global_agg_never_pads_or_copies_on_cuda(dev, monkeypatch):
    """On a CUDA tensor the wrapper launches on the matrix as it stands:
    F.pad, clone and contiguous are never called."""
    rng = np.random.default_rng(16)
    cases = []
    for m, f in ((32, 32), (64, 64), (7, 5), (100, 130)):
        x = _int8(rng, (m, f), dev)
        for op in ("sum", "mean"):
            mp = 1 << (m - 1).bit_length() if op == "mean" else m
            cases.append((x, op, tga.global_agg_ref(
                F.pad(x, (0, 0, 0, mp - m)), op=op)))
    x = _int8(rng, (1 + 64 * 64,), dev)[1:].view(64, 64)
    cases.append((x, "sum", tga.global_agg_ref(x)))

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path copied or padded its input")

    monkeypatch.setattr(torch.nn.functional, "pad", refuse)
    monkeypatch.setattr(torch.Tensor, "clone", refuse)
    monkeypatch.setattr(torch.Tensor, "contiguous", refuse)
    for x, op, want in cases:
        for impl in ("mac", "extract_add"):
            assert torch.equal(tga.global_agg(x, op=op, impl=impl), want)


def test_global_agg_takes_a_misaligned_view(dev):
    flat = _int8(np.random.default_rng(0), (1 + 8 * 128,), dev)
    x = flat[1:].view(8, 128)
    assert x.data_ptr() % 4
    assert torch.equal(tga.global_agg(x, impl="mac"), tga.global_agg_ref(x))


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,s,t,d,causal", [
    (4, 256, 256, 64, True), (2, 512, 512, 128, True), (3, 384, 384, 128, False),
    (2, 192, 192, 256, True), (2, 100, 100, 16, True), (1, 200, 72, 96, False),
    (1, 64, 200, 80, True),
    # S and T off the bf16 kernel's tiles (128 queries, 64 keys), T != S
    (2, 200, 200, 64, True), (2, 130, 300, 128, False), (2, 300, 130, 128, True),
    (1, 257, 257, 256, True), (2, 70, 190, 256, False), (2, 96, 96, 16, False),
    (1, 77, 77, 5, True), (1, 100, 61, 80, False),
    # B*H x query tiles above one wave of 132 SMs
    (160, 512, 512, 128, True), (300, 256, 256, 64, False)])
def test_flash_attention_equals_plain(dev, dtype, bh, s, t, d, causal):
    rng = np.random.default_rng(bh * s + d)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, n, d)).astype(np.float32))
               .to(dev, dtype) for n in (s, t, t))
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=s, block_k=t)
    want = tfa.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype],
                               rtol=FLASH_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_long_sequence_equals_plain(dev, causal):
    """S = T = 2048 at hd = 128: 32 key tiles through the f32 kernel's ring
    of three buffers, so each buffer is refilled ten times and more."""
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 2048, 128)).astype(
        np.float32)).to(dev) for _ in range(3))
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=128,
                              block_k=128)
    want = tfa.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bh,s,t,d,causal", [
    (4, 512, 512, 128, True), (2, 512, 512, 128, False),
    (2, 300, 130, 64, True), (1, 257, 257, 256, False)])
def test_flash_attention_f32_large_scores_equal_plain(dev, bh, s, t, d, causal):
    """q scaled by 8, so the scores are 8 times larger: the row max moves by
    many units from one key tile to the next and the rescale factor
    exp(m_old - m_new) is far from 1."""
    rng = np.random.default_rng(14 + d)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, n, d)).astype(
        np.float32)).to(dev) for n in (s, t, t))
    q = q * 8
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=s, block_k=t)
    want = tfa.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_mha_equals_plain(dev):
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(0, 1, (2, 200, 8, 64)).astype(np.float32)).to(dev)
    kv = torch.from_numpy(rng.normal(0, 1, (2, 2, 200, 2, 64)).astype(np.float32)).to(dev)
    got = tfa.flash_mha(q, kv[0], kv[1], block_q=64, block_k=64)
    want = tfa.flash_mha(q.cpu(), kv[0].cpu(), kv[1].cpu(), block_q=64,
                         block_k=64)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)


def test_flash_attention_bf16_takes_a_misaligned_view(dev):
    """d = 64 but q, k and v start 2 bytes past an alignment: the wrapper
    copies them to aligned storage for the bf16 kernel's tensor maps."""
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.normal(0, 1, 1 + 3 * 2 * 150 * 64).astype(
        np.float32)).to(dev, torch.bfloat16)
    q, k, v = flat[1:].view(3, 2, 150, 64)
    assert q.data_ptr() % 16
    got = tfa.flash_attention(q, k, v, causal=True, block_q=150, block_k=150)
    want = tfa.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [0.3, 0.0, -0.2])
def test_flash_attention_explicit_scale_equals_plain(dev, dtype, causal, scale):
    """A given scale of either sign, or 0: masked keys (causal) and the
    ragged keys past T = 130 still weigh nothing."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, n, 64)).astype(np.float32))
               .to(dev, dtype) for n in (200, 130, 130))
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=200,
                              block_k=130, scale=scale)
    want = tfa.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype],
                               rtol=FLASH_TOL[dtype])


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_flash_mha_bf16_equals_plain(dev, kv):
    rng = np.random.default_rng(10 + kv)
    q = torch.from_numpy(rng.normal(0, 1, (2, 200, 8, 128)).astype(
        np.float32)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(rng.normal(0, 1, (2, 200, kv, 128)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    got = tfa.flash_mha(q, k, v, block_q=64, block_k=64)
    want = tfa.flash_mha(q.cpu(), k.cpu(), v.cpu(), block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 200, 8 * 128)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_build_is_cached_by_source_hash(dev):
    _build.library()
    out = _build.BUILD_ROOT / _build.source_hash()
    assert (out / _build.LIB_NAME).exists()
    assert "registers" in (out / "build.log").read_text()


@pytest.mark.parametrize("mode", ["fused", "unfused"])
def test_server_on_cuda_equals_plain_server(dev, mode):
    rng = np.random.default_rng(2)
    q = _qmlp(rng, [16, 64, 32, 5])
    x = rng.integers(-60, 60, (16, 64, 16)).astype(np.int8)
    srv = JetServer(q, mode=mode, device=dev, max_batch=8, window_us=5000.0)
    ref = JetServer(q, mode="ref", device="cpu")
    try:
        reqs = [srv.submit(e) for e in x]
        for r, e in zip(reqs, x):
            assert r.event.wait(60) and r.error is None
            np.testing.assert_array_equal(r.result, ref.infer(e))
        assert max(srv.stats.batch_sizes) > 1
    finally:
        srv.close()
        ref.close()


def test_server_refuses_deepsets_unfused_on_cuda(dev):
    """DeepSets has no per-layer kernel path, so 'unfused' would serve the
    plain version on the card: refused there, kept for the CPU."""
    phi, rho = _deepsets(np.random.default_rng(3), 21, [32, 32], [10])
    with pytest.raises(ValueError, match="no per-layer kernel path"):
        JetServer(phi, rho=rho, mode="unfused", device=dev)
    JetServer(phi, rho=rho, mode="unfused", device="cpu").close()


def test_prepare_packs_cuda_models_once(dev):
    q = _qmlp(np.random.default_rng(4), [16, 32, 5]).to(dev)
    tcm.prepare(q, None)
    pc = tcm.ops._packed[q]                            # one layout
    assert isinstance(pc, tcm.ops.PackedChain)
    assert tcm.packed_mma_chain(q) is pc


def _recording_stream_of(monkeypatch):
    """Records the stream handle of every kernel launch and the thread
    that made it."""
    import threading
    seen = []
    real = _build.stream_of

    def stream_of(t):
        h = real(t)
        seen.append((threading.get_ident(), h))
        return h
    monkeypatch.setattr(_build, "stream_of", stream_of)
    return seen


def test_server_launches_on_its_own_stream(dev, monkeypatch):
    seen = _recording_stream_of(monkeypatch)
    q = _qmlp(np.random.default_rng(5), [16, 32, 5])
    x = np.random.default_rng(6).integers(-60, 60, (4, 64, 16)).astype(np.int8)
    srv = JetServer(q, device=dev)
    try:
        out = [srv.infer(e) for e in x]
    finally:
        srv.close()
    assert isinstance(srv.stream, torch.cuda.Stream)
    assert srv.stream != torch.cuda.default_stream(dev)
    assert srv.launch_streams == {srv.stream.cuda_stream}
    assert seen and {h for _, h in seen} == {srv.stream.cuda_stream}
    assert {t for t, _ in seen} == {srv._thread.ident}
    for e, o in zip(x, out):
        np.testing.assert_array_equal(o, tcm.cascade_mlp_ref(
            torch.from_numpy(e), q).numpy())
    cpu = JetServer(q, device="cpu")
    cpu.close()
    assert cpu.stream is None and cpu.launch_streams == set()


@pytest.mark.parametrize("mode", ["fused", "unfused"])
def test_fleet_replicas_launch_on_distinct_streams(dev, monkeypatch, mode):
    """Four replicas a tenant on the card: every gathered output equals the
    plain version, and every replica ran its batches on a stream of its
    own."""
    from repro_torch.serve.fleet import FleetServer, TenantSpec
    rng = np.random.default_rng(7)
    q = _qmlp(rng, [16, 64, 32, 32, 32, 5])
    tenants = [TenantSpec(name="mlp", qmlp=q, mode=mode, replicas=4)]
    xs = {"mlp": rng.integers(-60, 60, (64, 64, 16)).astype(np.int8)}
    if mode == "fused":
        phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
        tenants.append(TenantSpec(name="ds", qmlp=phi, rho=rho, replicas=4))
        xs["ds"] = rng.integers(-60, 60, (64, 32, 21)).astype(np.int8)
    seen = _recording_stream_of(monkeypatch)
    launches.reset()
    fleet = FleetServer(tenants, policy="rr", device=dev)
    try:
        results = {n: fleet.infer_batch(x, tenant=n, timeout=120)
                   for n, x in xs.items()}
    finally:
        fleet.close()
    counts = launches.snapshot()
    kernels = {"mlp": "cascade_mlp" if mode == "fused" else "mm_int8",
               "ds": "deepsets"}
    for name, br in results.items():
        assert counts.get(kernels[name], 0) > 0
        assert br.replica_counts == [16] * 4
        x = torch.from_numpy(xs[name])
        t = next(t for t in tenants if t.name == name)
        if t.rho is not None:
            plain = tcm.deepsets_ref(x, t.qmlp, t.rho)
        else:
            plain = tcm.cascade_mlp_ref(x.reshape(-1, 16), t.qmlp).reshape(
                64, 64, -1)
        np.testing.assert_array_equal(br.results, plain.numpy())
    servers = [s for ss in fleet._servers.values() for s in ss]
    handles = [s.stream.cuda_stream for s in servers]
    assert len(set(handles)) == len(servers)
    for s in servers:
        assert s.stats.batch_sizes, "a replica served no batch"
        assert s.launch_streams == {s.stream.cuda_stream}
    assert {h for _, h in seen} == set(handles)
