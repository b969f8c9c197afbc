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


SPAN_PHASES = ("repro_torch.checks", "repro_torch.pack", "repro_torch.alloc",
               "repro_torch.launch")


def _k2_k3_call(wrapper, dev):
    """A K2 or K3 call at the benchmark's widths, warmed up; its kernel's
    name."""
    rng = np.random.default_rng(11)
    if wrapper == "cascade_mlp":
        q = _qmlp(rng, [16, 64, 32, 32, 32, 5]).to(dev)
        x = _int8(rng, (64_000, 16), dev)
        call = lambda: tcm.cascade_mlp(x, q)  # noqa: E731
        kernel = "cascade_mlp_kernel"
    else:
        phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
        phi, rho = phi.to(dev), rho.to(dev)
        x = _int8(rng, (1000, 32, 21), dev, -40, 40)
        call = lambda: tcm.deepsets(x, phi, rho)  # noqa: E731
        kernel = "deepsets_kernel"
    call()
    torch.cuda.synchronize(dev)
    return call, kernel


@pytest.mark.parametrize("wrapper", ["cascade_mlp", "deepsets"])
def test_wrapper_spans_nest_in_order_around_the_launch(dev, wrapper):
    """Under the profiler a call is one of each phase, in order, inside the
    caller's range; the launch phase holds the runtime's launch of the
    kernel, which starts on the device after the phase starts."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels._build import spans
    call, kernel = _k2_k3_call(wrapper, dev)
    before = spans.totals()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("caller.call"):
            call()
        torch.cuda.synchronize(dev)
    events = prof.profiler.kineto_results.events()

    def host(name):
        return [e for e in events if e.name() == name
                and e.device_type().name == "CPU"]
    (outer,) = host("caller.call")
    phases = [host(name) for name in SPAN_PHASES]
    assert [len(p) for p in phases] == [1] * len(SPAN_PHASES)
    phases = [p[0] for p in phases]
    assert outer.start_ns() <= phases[0].start_ns()
    for a, b in zip(phases, phases[1:]):
        assert a.start_ns() <= a.end_ns() <= b.start_ns()
    assert phases[-1].end_ns() <= outer.end_ns()
    launch = phases[-1]
    runtime = [e for e in events if e.name().startswith("cudaLaunchKernel")
               and launch.start_ns() <= e.start_ns()
               and e.end_ns() <= launch.end_ns()]
    (k,) = [e for e in events if e.device_type().name == "CUDA"
            and kernel in e.name()]
    assert len(runtime) == 1
    assert runtime[0].correlation_id() == k.correlation_id()
    assert k.start_ns() > launch.start_ns()
    after = spans.totals()
    for name in SPAN_PHASES:
        assert after[name][0] == before.get(name, (0, 0))[0] + 1


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


# (BH, S, T, d, window): windows of one key, of one key tile less one and
# exactly one (64 keys, the bf16 kernel's tile; the f32 kernel's at d <= 128),
# off the tiles, and as wide as S; S and T on and off the tiles, T != S.
WINDOWED_FLASH = [
    (2, 256, 256, 64, 1), (2, 256, 256, 128, 63), (2, 256, 256, 128, 64),
    (2, 300, 300, 128, 100), (2, 200, 200, 64, 200), (1, 200, 200, 64, 500),
    (3, 384, 384, 96, 100), (2, 130, 300, 128, 64), (2, 300, 130, 128, 63),
    (1, 257, 257, 256, 100), (2, 1024, 1024, 128, 300), (1, 77, 77, 5, 8),
    (160, 512, 512, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bh,s,t,d,window", WINDOWED_FLASH)
def test_windowed_flash_attention_equals_plain(dev, dtype, bh, s, t, d,
                                               window):
    """The window skips whole key tiles below it and masks the edge tile:
    the output equals the plain version's masked softmax, and differs from
    the window-free call where the window binds."""
    rng = np.random.default_rng(bh * s + d + window)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, n, d)).astype(np.float32))
               .to(dev, dtype) for n in (s, t, t))
    launches.reset()
    got = tfa.flash_attention(q, k, v, causal=True, block_q=s, block_k=t,
                              window=window)
    assert launches.snapshot() == {"flash_attn": 1}
    want = tfa.flash_attention_ref(q, k, v, causal=True, window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype],
                               rtol=FLASH_TOL[dtype])
    if window < min(s, t):
        free = tfa.flash_attention_ref(q, k, v, causal=True)
        assert float((free.float() - want.float()).abs().max()) > 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_windowed_flash_attention_rows_that_see_no_key_are_zero(dev, dtype):
    """S = 300 queries on T = 64 keys with a window of 50: rows 113.. see
    no key; whole query tiles visit no key tile. They write 0, as the plain
    version and the reference's chunked scan give."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(0, 1, (2, 300, 64)).astype(
        np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.normal(0, 1, (2, 64, 64)).astype(
        np.float32)).to(dev, dtype) for _ in range(2))
    got = tfa.flash_attention(q, k, v, causal=True, block_q=300, block_k=64,
                              window=50)
    want = tfa.flash_attention_ref(q, k, v, causal=True, window=50)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype],
                               rtol=FLASH_TOL[dtype])
    assert not bool(got[:, 113:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_windowed_flash_mha_gqa_equals_plain(dev, dtype):
    """mixtral's GQA ratio (4 query heads a KV head) and hd 128 with a
    window of 100, S = 600 off the tiles, through flash_mha."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.normal(0, 1, (2, 600, 8, 128)).astype(
        np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.normal(0, 1, (2, 600, 2, 128)).astype(
        np.float32)).to(dev, dtype) for _ in range(2))
    got = tfa.flash_mha(q, k, v, window=100)
    want = tfa.flash_mha(q.cpu(), k.cpu(), v.cpu(), window=100)
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


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


JSC_M = [16, 64, 32, 32, 32, 5]


@pytest.mark.parametrize("rows", [0, 1, 31, 32, 33, 64000])
def test_cascade_mlp_plan_equals_plain(dev, rows):
    """K2 through its launch plan, built by ``prepare``, at jsc-m's widths:
    a call builds nothing and equals the plain version."""
    rng = np.random.default_rng(20 + rows)
    q = _qmlp(rng, JSC_M).to(dev)
    tcm.prepare(q)
    built = _build.plans.get("cascade_mlp")
    x = _int8(rng, (rows, 16), dev)
    out = tcm.cascade_mlp(x, q)
    assert out.shape == (rows, 5)
    assert torch.equal(out, tcm.cascade_mlp_ref(x, q))
    assert _build.plans.get("cascade_mlp") == built


@pytest.mark.parametrize("m", [1, 5, 32, 33])
def test_deepsets_plan_equals_plain(dev, m):
    """K3 through one launch plan for every batch (0, 1, 2, 3, 1000) and the
    2-D single-set form, at deepsets-32's widths."""
    rng = np.random.default_rng(30 + m)
    phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
    phi, rho = phi.to(dev), rho.to(dev)
    mp = 1 << (m - 1).bit_length()
    built = _build.plans.get("deepsets")
    for batch in (0, 1, 2, 3, 1000):
        x = _int8(rng, (batch, m, 21), dev, -40, 40)
        out = tcm.deepsets(x, phi, rho)
        assert out.shape == (batch, 1, 10)
        want = tcm.deepsets_ref(F.pad(x, (0, 0, 0, mp - m)), phi, rho)
        assert torch.equal(out, want)
    one = tcm.deepsets(x[7], phi, rho)
    assert one.shape == (1, 10) and torch.equal(one, want[7])
    assert _build.plans.get("deepsets") == built + 1


def test_one_plan_a_model_and_one_a_pair(dev):
    """100 calls of a model build one K2 plan; a phi with its rho one K3
    plan, and with a new rho a second."""
    rng = np.random.default_rng(40)
    q = _qmlp(rng, JSC_M).to(dev)
    phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
    phi, rho = phi.to(dev), rho.to(dev)
    _, rho2 = _deepsets(rng, 21, [32, 32, 32], [32, 10])
    rho2 = rho2.to(dev)
    x2, x3 = _int8(rng, (100, 16), dev), _int8(rng, (4, 32, 21), dev, -40, 40)
    before = _build.plans.snapshot()
    for _ in range(100):
        tcm.cascade_mlp(x2, q)
        tcm.deepsets(x3, phi, rho)
    after = _build.plans.snapshot()
    assert after.get("cascade_mlp", 0) == before.get("cascade_mlp", 0) + 1
    assert after.get("deepsets", 0) == before.get("deepsets", 0) + 1
    assert torch.equal(tcm.deepsets(x3, phi, rho2),
                       tcm.deepsets_ref(x3, phi, rho2))
    assert _build.plans.get("deepsets") == after.get("deepsets", 0) + 1
    assert tcm.ops._k3_plans[phi].rho() is rho2


def test_threads_racing_to_a_models_first_call_build_one_plan(dev):
    """16 threads make a fresh model's first call at once, with the
    interpreter switching threads as often as it can: one K2 plan and one
    K3 plan are built, and every output equals the plain version."""
    import sys
    import threading
    rng = np.random.default_rng(43)
    q = _qmlp(rng, JSC_M).to(dev)
    phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
    phi, rho = phi.to(dev), rho.to(dev)
    x2, x3 = _int8(rng, (64, 16), dev), _int8(rng, (8, 32, 21), dev, -40, 40)
    want2, want3 = tcm.cascade_mlp_ref(x2, q), tcm.deepsets_ref(x3, phi, rho)
    before = _build.plans.snapshot()
    start, outs = threading.Barrier(16), []

    def call():
        start.wait(30)
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            got = (tcm.cascade_mlp(x2, q), tcm.deepsets(x3, phi, rho))
        s.synchronize()
        outs.append(got)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(outs) == 16
    after = _build.plans.snapshot()
    for kernel in ("cascade_mlp", "deepsets"):
        assert after.get(kernel, 0) == before.get(kernel, 0) + 1
    for out2, out3 in outs:
        assert torch.equal(out2, want2) and torch.equal(out3, want3)


def test_a_plans_handle_is_freed_with_its_model(dev):
    import gc
    rng = np.random.default_rng(41)
    q = _qmlp(rng, JSC_M).to(dev)
    phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
    phi, rho = phi.to(dev), rho.to(dev)
    tcm.cascade_mlp(_int8(rng, (40, 16), dev), q)
    tcm.deepsets(_int8(rng, (2, 32, 21), dev, -40, 40), phi, rho)
    freed = [tcm.ops._k2_plans[q].freed, tcm.ops._k3_plans[phi].freed]
    assert all(f.alive for f in freed)
    del q, phi
    gc.collect()
    assert not any(f.alive for f in freed)


def test_a_plan_launches_on_the_callers_stream(dev, monkeypatch):
    """The plan holds no stream: a launch under ``torch.cuda.stream(s)``
    and one from another thread run on that thread's current stream."""
    import threading
    raw = _build.stream_of
    seen = _recording_stream_of(monkeypatch)
    rng = np.random.default_rng(42)
    q = _qmlp(rng, JSC_M).to(dev)
    phi, rho = _deepsets(rng, 21, [32, 32, 32], [32, 10])
    phi, rho = phi.to(dev), rho.to(dev)
    x2, x3 = _int8(rng, (500, 16), dev), _int8(rng, (30, 32, 21), dev, -40, 40)
    want2, want3 = tcm.cascade_mlp_ref(x2, q), tcm.deepsets_ref(x3, phi, rho)
    tcm.cascade_mlp(x2, q)
    tcm.deepsets(x3, phi, rho)
    assert {h for _, h in seen} == {torch.cuda.current_stream(dev).cuda_stream}
    got = {}

    def on(stream, key):
        with torch.cuda.stream(stream):
            assert raw(x2) == stream.cuda_stream
            got[key] = (tcm.cascade_mlp(x2, q), tcm.deepsets(x3, phi, rho))
        stream.synchronize()

    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    seen.clear()
    on(s1, "here")
    t = threading.Thread(target=on, args=(s2, "thread"))
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert [h for _, h in seen] == [s1.cuda_stream] * 2 + [s2.cuda_stream] * 2
    assert seen[-1][0] == t.ident
    assert set(got) == {"here", "thread"}
    for out2, out3 in got.values():
        assert torch.equal(out2, want2) and torch.equal(out3, want3)


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


def test_server_serves_its_first_batch_without_a_cuda_malloc(dev):
    """The server primes its stream at start, so that no request waits on
    the cudaMalloc of its stream's first device memory."""
    q = _qmlp(np.random.default_rng(8), [16, 64, 32, 5])
    x = np.random.default_rng(9).integers(-60, 60, (64, 64, 16)).astype(np.int8)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()        # no stream keeps a cached block
    srv = JetServer(q, device=dev, max_batch=64, window_us=5000.0)
    try:
        m0 = torch.cuda.memory_stats(dev)["segment.all.allocated"]
        reqs = [srv.submit(e) for e in x]
        for r in reqs:
            assert r.event.wait(60) and r.error is None
        assert torch.cuda.memory_stats(dev)["segment.all.allocated"] == m0
    finally:
        srv.close()


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


# -- the dense LM path (models.build) ------------------------------------------

# max |diff| / max |logit| between two runs of the same weights. K5 bf16 packs
# the unnormalized softmax weights to bf16 and divides at the end; the plain
# version keeps them in f32, and decode's attention casts the normalized
# weights to bf16. Each moves every logit by about one bf16 ulp of the
# largest (2^-8 = 0.4%); 0.02 is five, as tests/test_torch_lm.py holds the
# port to the JAX package.
LOGIT_TOL = 0.02
# The MoE archs: the reference's own compiled and op-by-op forwards differ by
# up to 0.022 of the largest logit at llama4 reduced (its experts' outputs are
# large, so an ulp of the router's input moves the logits more); see
# tests/test_torch_lm.py. A router near-tie may also flip an expert pick
# between two runs that round apart (K5 on the card, its plain version on the
# CPU): a flip moves that token, and through attention and capacity the later
# ones, by order 1, so the logits are compared before the first position
# whose routing differs, and a pick that differs where every earlier layer
# routed the same must be a near-tie (the picked and unpicked probabilities
# within NEAR_TIE, relative).
MOE_LOGIT_TOL, NEAR_TIE = 0.04, 2e-2
LM_ARCHS = ["qwen3-14b", "granite-8b", "qwen1.5-32b", "mixtral-8x7b",
            "llama4-maverick-400b-a17b", "minicpm3-4b", "qwen2-vl-72b"]


def _lm_cfg(name):
    """The reduced arch, or (name + "-hd128") qwen3-14b's head dim and GQA
    ratio at 4 layers: the shapes the full model gives K5."""
    from repro_torch import configs
    if name.endswith("-hd128"):
        return dataclasses.replace(
            configs.get_reduced(name[:-6]), n_layers=4, d_model=640,
            n_heads=5, n_kv=1, head_dim=128, d_ff=1024, vocab=1024)
    return configs.get_reduced(name)


def _rel(got, want):
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max())


@pytest.fixture
def bf16_full_reduction():
    """bf16 GEMMs on the card reduce in f32, as XLA's and torch's CPU ones."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.parametrize("name", LM_ARCHS + ["qwen3-14b-hd128"])
def test_transformer_on_cuda_equals_cpu(dev, bf16_full_reduction, name):
    """The same weights on the card and on the CPU: K5 launches once a
    layer a forward on the card, the plain version runs on the CPU."""
    from repro_torch.models import Transformer, init_params
    from repro_torch.models import moe as M
    cfg = _lm_cfg(name)
    params = init_params(cfg, device=torch.device("cpu"), seed=1)
    cpu = Transformer(cfg, params)
    gpu = Transformer(cfg, {
        "embedding": {"emb": params["embedding"]["emb"].to(dev)},
        "final_norm": {k: v.to(dev) for k, v in params["final_norm"].items()},
        "layers": [_to(p, dev) for p in params["layers"]]})
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 200)))
    logs = {"gpu": [], "cpu": []}
    launches.reset()
    with M.routing_log(logs["gpu"]):
        got, _ = gpu(toks.to(dev))
    torch.cuda.synchronize()
    assert launches.snapshot().get("flash_attn", 0) == cfg.n_layers
    with M.routing_log(logs["cpu"]):
        want, _ = cpu(toks)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    if not cfg.n_experts:
        assert _rel(got, want) <= LOGIT_TOL
        return
    assert len(logs["gpu"]) == len(logs["cpu"]) == sum(
        k == "attn_moe" for k in cpu.kinds)
    split = _routing_split(logs["cpu"], logs["gpu"], cfg.top_k)
    for g, t in enumerate(split):
        assert t > 0
        assert _rel(got[g, :t], want[g, :t]) <= MOE_LOGIT_TOL


def _near_tie_gap(probs, k: int):
    """How far apart, relative, each token's k-th and (k+1)-th largest
    router probabilities lie: the margin of its set of chosen experts."""
    top = probs.float().topk(k + 1, dim=-1).values
    return ((top[..., k - 1] - top[..., k]) / top[..., k - 1]).cpu()


def _experts(ids, keep=None):
    """A token's chosen (with ``keep``, kept) experts as a sorted set, -1
    for a dropped choice: the order of the top-k, which two near-equal
    gates may swap, changes no output where nothing is dropped."""
    if keep is not None:
        ids = ids.masked_fill(~keep, -1)
    return ids.sort(dim=-1).values.cpu()


def _routing_split(ref_log, other_log, k):
    """Per group, the first position where any layer's expert picks or kept
    choices differ between two runs of the same model (layer by layer, in
    order). Before that position every earlier layer routed alike, so a
    pick that differs there can only be a near-tie in ``ref_log``; fails on
    any other."""
    s_len = ref_log[0].expert_ids.shape[1]
    split = [s_len] * ref_log[0].expert_ids.shape[0]
    for layer, (a, b) in enumerate(zip(ref_log, other_log)):
        picks = (_experts(a.expert_ids) != _experts(b.expert_ids)).any(-1)
        differ = picks | (_experts(a.expert_ids, a.keep)
                          != _experts(b.expert_ids, b.keep)).any(-1)
        gap = _near_tie_gap(a.probs, k)
        first = list(split)
        for g in range(len(split)):
            for p in picks[g].nonzero()[:, 0].tolist():
                assert p >= split[g] or gap[g, p] < NEAR_TIE, (
                    f"layer {layer}, group {g}, position {p}: other experts "
                    f"with their probabilities {float(gap[g, p]):.3e} apart")
            where = differ[g].nonzero()
            if len(where):
                first[g] = min(first[g], int(where[0]))
        split = first
    return split


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("name", ["granite-8b", "qwen3-14b-hd128",
                                  "minicpm3-4b"])
def test_decode_matches_forward_on_cuda(dev, bf16_full_reduction, name):
    """Decode from an empty cache reproduces the forward's logits on the
    card, as tests/test_arch_smoke.py holds the reference's."""
    from repro_torch.models import build
    cfg = _lm_cfg(name)
    model = build(cfg, device=dev, seed=0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 6))).to(dev)
    full, _ = model(toks)
    cache = model.init_cache(2, 32)
    launches.reset()
    outs = []
    for t in range(6):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        outs.append(lg)
    assert launches.snapshot().get("flash_attn", 0) == 0
    dec = torch.cat(outs, dim=1)
    assert _rel(dec, full) <= LOGIT_TOL
    assert bool((dec.argmax(-1) == full.argmax(-1)).all())


def test_non_causal_attention_on_cuda_launches_k5_once(dev):
    """Whisper's encoder attention (no mask, no RoPE) on the card: one K5
    launch, equal to the same layer on the CPU (K5's plain version) within
    LOGIT_TOL; S = 150 is off the key tiles, so a visible padded key would
    show."""
    from repro_torch.models import attention as A
    cfg = A.AttnConfig(d_model=256, n_heads=4, n_kv=2, head_dim=64,
                       causal=False, use_rope=False)
    g = torch.Generator().manual_seed(0)
    p = A.attn_init(g, cfg, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, 150, 256)).astype(np.float32)).to(torch.bfloat16)
    launches.reset()
    got = A.attention(_to(p, dev), x.to(dev), cfg)
    assert launches.snapshot() == {"flash_attn": 1}
    assert _rel(got, A.attention(p, x, cfg)) <= LOGIT_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,h,kv,hd", [
    (2, 1500, 1500, 8, 8, 64),      # whisper-base's encoder
    (2, 448, 1500, 8, 8, 64),       # its cross attention
    (2, 150, 150, 4, 2, 64),
    (1, 12, 150, 4, 1, 256)])
def test_flash_mha_non_causal_equals_plain(dev, dtype, b, s, t, h, kv, hd):
    """``flash_mha(causal=False)`` on the card against the plain version of
    the same call on the CPU: q padded to the grid, the true T handed to
    the kernel (1500 and 150 are off its key tiles)."""
    rng = np.random.default_rng(s + t + hd)
    q = torch.from_numpy(rng.normal(0, 1, (b, s, h, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (b, t, kv, hd)).astype(
        np.float32)) for _ in range(2))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    launches.reset()
    got = tfa.flash_mha(q.to(dev), k.to(dev), v.to(dev), causal=False)
    assert launches.snapshot() == {"flash_attn": 1}
    want = tfa.flash_mha(q, k, v, causal=False)
    assert got.dtype == dtype and got.shape == (b, s, h * hd)
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


#: K5 launches a prefill of each reduced arch: recurrentgemma's two local
#: attention layers, none in xlstm, whisper's 2 encoder + 2 x 2 decoder
#: (self and cross) attentions.
NEW_ARCHS = {"recurrentgemma-2b": 2, "xlstm-350m": 0, "whisper-base": 6}


def _built_pair(name, dev):
    """The reduced arch with the same random weights on the CPU and on the
    card."""
    from repro_torch import configs
    from repro_torch.models import EncDec, Transformer, encdec, init_params
    cfg = configs.get_reduced(name)
    if cfg.enc_layers:
        params = encdec.init_params(cfg, device=torch.device("cpu"), seed=1)
        return cfg, EncDec(cfg, params), EncDec(cfg, _to(params, dev))
    params = init_params(cfg, device=torch.device("cpu"), seed=1)
    return cfg, Transformer(cfg, params), Transformer(cfg, _to(params, dev))


def _drive(model, cfg, toks, frames, f32):
    """The prefill's inputs: tokens (and whisper's frames), or for xlstm in
    f32 the embedding rows (tests/test_torch_lm.py says why)."""
    if cfg.enc_layers:
        return model(toks, frames)
    if f32:
        return model(None, embeds=model.embedding["emb"].float()[toks])
    return model(toks)


@pytest.mark.parametrize("name", list(NEW_ARCHS))
def test_recurrent_and_encdec_on_cuda_equal_cpu(dev, bf16_full_reduction,
                                                name):
    """The same weights on the card and on the CPU: the prefill launches K5
    exactly NEW_ARCHS[name] times (once a local-attention layer; the
    encoder, decoder self and cross attentions), and its logits equal the
    CPU's within LOGIT_TOL. xlstm runs in f32 (TF32 off), as its CPU test
    does: in bf16 its 16 blocks amplify a rounding difference."""
    cfg, cpu, gpu = _built_pair(name, dev)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 200)))
    frames = (torch.from_numpy(rng.normal(0, 1, (2, 150, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16) if cfg.enc_layers else None)
    f32 = name == "xlstm-350m"
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        launches.reset()
        got, _ = _drive(gpu, cfg, toks.to(dev),
                        None if frames is None else frames.to(dev), f32)
        torch.cuda.synchronize()
        assert launches.snapshot().get("flash_attn", 0) == NEW_ARCHS[name]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    want, _ = _drive(cpu, cfg, toks, frames, f32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= LOGIT_TOL


@pytest.mark.parametrize("name", list(NEW_ARCHS))
def test_recurrent_and_encdec_decode_matches_forward_on_cuda(
        dev, bf16_full_reduction, name):
    """Eight decode steps on the card (recurrent states, ring caches, the
    encoder's cross K/V) reproduce the card's own prefill logits, with no
    K5 launch."""
    from repro_torch import configs
    from repro_torch.models import build
    cfg = configs.get_reduced(name)
    model = build(cfg, device=dev, seed=0)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8))).to(dev)
    f32 = name == "xlstm-350m"
    if cfg.enc_layers:
        frames = torch.from_numpy(rng.normal(0, 1, (2, 150, cfg.d_model))
                                  .astype(np.float32)).to(dev, torch.bfloat16)
        full, _ = model(toks, frames)
        cache = model.init_cache(frames, 32)
    else:
        full, _ = _drive(model, cfg, toks, None, f32)
        cache = model.init_cache(2, 32)
    emb = model.embedding["emb"].float()[toks] if f32 else None
    launches.reset()
    outs = []
    for t in range(8):
        if f32:
            lg, cache = model.decode_step(None, cache,
                                          embeds=emb[:, t:t + 1])
        else:
            lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        outs.append(lg)
    assert launches.snapshot().get("flash_attn", 0) == 0
    assert _rel(torch.cat(outs, dim=1), full) <= LOGIT_TOL


def test_windowed_attention_on_cuda_launches_k5_with_the_window(dev):
    """mixtral's attention (a window) on the card: one K5 launch, equal to
    the same layer on the CPU (K5's plain version) within LOGIT_TOL."""
    from repro_torch.models import attention as A
    cfg = A.AttnConfig(d_model=256, n_heads=4, n_kv=1, head_dim=64,
                       window=100)
    g = torch.Generator().manual_seed(0)
    p = A.attn_init(g, cfg, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 333, 256)).astype(np.float32)).to(torch.bfloat16)
    launches.reset()
    got = A.attention(_to(p, dev), x.to(dev), cfg)
    assert launches.snapshot() == {"flash_attn": 1}
    assert _rel(got, A.attention(p, x, cfg)) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

#: Reduced archs whose train step on the card is held against the CPU's:
#: dense, MoE, MLA, RG-LRU with local attention, encoder-decoder.
TRAIN_ARCHS = ["granite-8b", "mixtral-8x7b", "minicpm3-4b",
               "recurrentgemma-2b", "whisper-base"]
#: tests/test_torch_train.py's bounds against the reference, here between
#: the card and the CPU (the same bf16 products, reduced in another order):
#: loss and ce relative, the grad norm relative, each leaf's gradient
#: (the worst leaf's ||g_card - g_cpu|| / ||g_cpu||: a lost gradient scores
#: 1, a reversed one 2; this file run as a script prints the readings, on
#: an H100 1.0e-4 (mixtral) to 1.22e-2 (recurrentgemma's RG-LRU input
#: weight)), the params after one AdamW step absolute (2.5 x lr: Adam's
#: first step is sign-like).
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_GRAD_RTOL = 2e-3, 2e-2, 0.1
TRAIN_OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _train_batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.frontend == "vision_stub":
        out["embeds"] = torch.from_numpy(rng.normal(
            0, 1, (b, s, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    else:
        out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    if cfg.enc_layers:
        out["frames"] = torch.from_numpy(rng.normal(
            0, 1, (b, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    return out


def _train_pair(name, dev):
    """(cfg, the same f32 weights on the CPU and on the card, a batch); the
    MoE arch without remat (its card layers take the CPU's routings, one a
    forward)."""
    from repro_torch import configs
    from repro_torch.models import build, params_from_numpy, params_to_numpy
    cfg = configs.get_reduced(name)
    remat = not cfg.n_experts
    cpu = build(cfg, device="cpu", seed=1, remat=remat,
                weight_dtype=torch.float32)
    gpu = params_from_numpy(cfg, params_to_numpy(cfg, cpu), device=dev,
                            remat=remat, weight_dtype=torch.float32)
    return cfg, cpu, gpu, _train_batch(cfg)


def _leaf_grad_errors(cfg, cpu, gpu, batch, dev):
    """(||g_card - g_cpu|| / ||g_cpu||, path) a leaf of ``params()``, worst
    first: ``steps.loss_and_grads`` of both models on ``batch``, each card
    MoE layer routed as the CPU's. A leaf whose CPU gradient is 0 scores 0
    only if the card's is 0 too."""
    from repro_torch._tree import flatten_with_paths
    from repro_torch.data import place
    from repro_torch.distributed import steps
    from repro_torch.models import moe as M
    log = []
    with M.routing_log(log):
        want = steps.loss_and_grads(cfg, cpu, batch)[2]
    pick = None
    if cfg.n_experts:
        pick = lambda i: (log[i].expert_ids.to(dev),  # noqa: E731
                          log[i].keep.to(dev))
    with M.routing_log([], pick):
        got = steps.loss_and_grads(cfg, gpu, place(batch, dev))[2]
    paths = [p for p, _ in flatten_with_paths(cpu.params())]
    assert len(paths) == len(got) == len(want)
    errs = []
    for path, a, b in zip(paths, got, want):
        d = float((a.double().cpu() - b.double()).norm())
        n = float(b.double().norm())
        errs.append((d / n if n else (0.0 if d == 0 else float("inf")),
                     "/".join(path)))
    return sorted(errs, reverse=True)


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_train_step_on_cuda_equals_cpu(dev, bf16_full_reduction, name):
    """The same f32 weights and batch, one train step on the card and one
    on the CPU: K5 launches 0 times on the card (training runs the
    reference's attention under autograd), and the loss, ce, grad norm,
    every leaf's gradient (``_leaf_grad_errors``) and the params agree
    within the bounds above. Each card MoE layer takes the CPU's experts
    (``moe.routing_log`` with a pick), so that a router near-tie rounds no
    token elsewhere."""
    from repro_torch import optim
    from repro_torch.distributed import steps
    from repro_torch.models import moe as M
    cfg, cpu, gpu, batch = _train_pair(name, dev)
    launches.reset()
    worst = _leaf_grad_errors(cfg, cpu, gpu, batch, dev)[0]
    assert worst[0] <= TRAIN_LEAF_GRAD_RTOL, worst
    assert launches.snapshot().get("flash_attn", 0) == 0
    out, log = {}, []
    for where, model in (("cpu", cpu), ("gpu", gpu)):
        step = steps.make_train_step(cfg, optim.AdamWConfig(**TRAIN_OCFG),
                                     device=model.device)
        pick = None
        if where == "gpu" and cfg.n_experts:
            cpu_log = list(log)
            pick = lambda i: (cpu_log[i].expert_ids.to(dev),  # noqa: E731
                              cpu_log[i].keep.to(dev))
        launches.reset()
        with M.routing_log(log if where == "cpu" else [], pick):
            model, st, m = step(model, optim.init(model.params()), batch)
        torch.cuda.synchronize()
        if where == "gpu":
            assert launches.snapshot().get("flash_attn", 0) == 0
        out[where] = model, {k: float(v) for k, v in m.items()}
    (mc, c), (mg, g) = out["cpu"], out["gpu"]
    assert all(np.isfinite(v) for v in g.values())
    for k, tol in (("loss", TRAIN_LOSS_RTOL), ("ce", TRAIN_LOSS_RTOL),
                   ("grad_norm", TRAIN_GNORM_RTOL)):
        assert abs(g[k] - c[k]) <= tol * abs(c[k]), (k, g[k], c[k])
    want = dict(mc.named_parameters())
    assert set(want) == set(dict(mg.named_parameters()))
    for name_, b in mg.named_parameters():
        assert float((want[name_] - b.cpu()).abs().max()) <= (
            2.5 * TRAIN_OCFG["lr"]), name_
        assert not b.requires_grad


@pytest.mark.parametrize("name", ["granite-8b", "recurrentgemma-2b",
                                  "whisper-base"])
def test_make_prefill_still_launches_k5_once_a_layer(dev, name):
    """``make_prefill`` (inference mode) on weights that were trained:
    K5 launches once an attention layer (whisper: encoder, self and cross
    attention), as the serving prefill does."""
    from repro_torch import configs, optim
    from repro_torch.distributed import steps
    from repro_torch.models import build
    cfg = configs.get_reduced(name)
    model = build(cfg, device=dev, seed=2, remat=True,
                  weight_dtype=torch.float32)
    batch = {k: v.to(dev) for k, v in _train_batch(cfg).items()}
    model, _, _ = steps.make_train_step(cfg, optim.AdamWConfig(**TRAIN_OCFG),
                                        device=dev)(
        model, optim.init(model.params()), batch)
    want = (cfg.enc_layers + 2 * cfg.n_layers if cfg.enc_layers else
            sum(k in ("attn", "attn_moe", "mla") for k in model.kinds))
    launches.reset()
    logits = steps.make_prefill(cfg, device=dev)(model.cast(torch.bfloat16),
                                                 batch)
    torch.cuda.synchronize()
    assert launches.snapshot() == {"flash_attn": want}
    assert bool(torch.isfinite(logits).all())


def test_flash_mha_refuses_a_cuda_input_that_requires_grad(dev):
    q = torch.randn(1, 128, 2, 64, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, 128, 2, 64, device=dev, dtype=torch.bfloat16)
    launches.reset()
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_mha(q.clone().requires_grad_(True), k, k)
    assert launches.snapshot() == {}
    with torch.no_grad():
        tfa.flash_mha(q.clone().requires_grad_(True), k, k)
    assert launches.snapshot() == {"flash_attn": 1}


@pytest.mark.parametrize("name", ["qwen3-14b-hd128", "mixtral-8x7b"])
def test_mesh_prefill_on_one_rank_launches_k5_once_a_layer(dev, name):
    """``make_prefill(mesh=...)`` on the one-rank nccl host mesh, the
    weights placed by ``params_sharding``: K5 launches once a layer, and
    the logits equal the unsharded prefill's (torch.equal: a one-rank mesh
    cuts nothing, and every op runs on the same local tensors)."""
    import torch.distributed as dist
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import shard_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Transformer, init_params
    cfg = _lm_cfg(name)
    model = Transformer(cfg, init_params(cfg, device=dev, seed=1))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 200))).to(dev)}
    want = steps.make_prefill(cfg, device=dev)(model, batch)
    mesh = make_host_mesh(device=dev)
    assert dist.get_backend() == "nccl" and mesh.size() == 1
    shard_model(model, mesh)
    launches.reset()
    got = steps.make_prefill(cfg, mesh=mesh, device=dev)(model, batch)
    torch.cuda.synchronize()
    assert launches.snapshot() == {"flash_attn": cfg.n_layers}
    assert torch.equal(got.full_tensor(), want)


def test_compression_on_cuda_equals_cpu(dev):
    """``compress`` / ``decompress`` on the card equal the CPU's bit for
    bit, and ``compressed_psum`` over a one-rank nccl ``pod`` group gives
    q times the scale and the same error."""
    from repro_torch.distributed import compression
    from repro_torch.launch.mesh import make_mesh
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(0, 1e-2, (300, 129)).astype(np.float32))
    e = torch.from_numpy(rng.normal(0, 1e-4, (300, 129)).astype(np.float32))
    q, s, ne = compression.compress(g, e)
    qd, sd, ned = compression.compress(g.to(dev), e.to(dev))
    assert torch.equal(qd.cpu(), q) and float(sd) == float(s)
    assert torch.equal(ned.cpu(), ne)
    assert torch.equal(compression.decompress(qd, sd).cpu(),
                       compression.decompress(q, s))
    group = make_mesh((1,), ("pod",), device=dev).get_group("pod")
    (g2,), (e2,) = compression.compressed_psum([g.to(dev)], [e.to(dev)],
                                               group)
    assert torch.equal(g2.cpu(), compression.decompress(q, s))
    assert torch.equal(e2.cpu(), ne)


def test_flash_mha_f32_at_s200_holds_over_repeats(dev):
    """``test_flash_mha_equals_plain`` (K5 f32, S = 200, GQA) failed once on
    an H100 (318 of 204,800 values up to 6.5e-5 off): the same inputs 200
    times over, each output within its 2e-5."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(0, 1, (2, 200, 8, 64)).astype(
        np.float32)).to(dev)
    kv = torch.from_numpy(rng.normal(0, 1, (2, 2, 200, 2, 64)).astype(
        np.float32)).to(dev)
    want = tfa.flash_mha(q.cpu(), kv[0].cpu(), kv[1].cpu(), block_q=64,
                         block_k=64)
    for _ in range(200):
        got = tfa.flash_mha(q, kv[0], kv[1], block_q=64, block_k=64).cpu()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


if __name__ == "__main__":
    # The readings behind TRAIN_LEAF_GRAD_RTOL, on a CUDA machine:
    #   PYTHONPATH=src python tests/test_torch_cuda.py
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for arch in TRAIN_ARCHS:
        errs = _leaf_grad_errors(*_train_pair(arch, torch.device("cuda")),
                                 torch.device("cuda"))
        print(f"{arch}: {len(errs)} leaves, the worst {errs[:3]}")
