"""The port's kernel wrappers against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
wrappers run their Pallas kernels in interpret mode, as the JAX package's own
tests do. INT8 is exact, so every comparison is equality. The CUDA kernels
themselves are held against their plain versions in test_torch_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.kernels import cascade_mlp as jcm
from repro.kernels import mm_int8 as jmm
from repro_torch.kernels import _build, cascade_mlp as tcm, mm_int8 as tmm
from repro_torch import quant as tquant
from repro_torch.quant import QuantizedMLP


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _float_chain(rng, dims, m):
    ws = [rng.normal(0, 0.4, (dims[i], dims[i + 1])) for i in range(len(dims) - 1)]
    bs = [rng.normal(0, 0.1, (d,)) for d in dims[1:]]
    relus = [True] * (len(ws) - 1) + [False]
    return ws, bs, relus, rng.normal(0, 1, (m, dims[0]))


def _models(rng, dims, m):
    """The same quantized MLP in both packages, and int8 input for it."""
    ws, bs, relus, xs = _float_chain(rng, dims, m)
    ref = jq.quantize_mlp(ws, bs, relus, xs)
    xq, _ = jq.quantize_pow2(xs)
    return ref, QuantizedMLP.from_arrays(ref), np.array(xq)


def _deepsets_models(rng, f, phi_nodes, rho_nodes, m):
    dims = [f] + list(phi_nodes)
    pw = [rng.normal(0, 0.4, (dims[i], dims[i + 1])) for i in range(len(dims) - 1)]
    pb = [rng.normal(0, 0.1, (d,)) for d in dims[1:]]
    xs = rng.normal(0, 1, (m, f))
    phi = jq.quantize_mlp(pw, pb, [True] * len(pw), xs)
    h = xs
    for w, b in zip(pw, pb):
        h = np.maximum(h @ w + b, 0)
    rdims = [dims[-1]] + list(rho_nodes)
    rw = [rng.normal(0, 0.3, (rdims[i], rdims[i + 1])) for i in range(len(rdims) - 1)]
    rb = [rng.normal(0, 0.1, (d,)) for d in rdims[1:]]
    rho = jq.quantize_mlp(rw, rb, [True] * (len(rw) - 1) + [False],
                          h.mean(0, keepdims=True))
    return phi, rho, QuantizedMLP.from_arrays(phi), QuantizedMLP.from_arrays(rho)


# -- K1 mm_int8 -------------------------------------------------------------------

MM_SHAPES = [(1, 5, 5), (7, 21, 10), (8, 16, 32), (32, 130, 200),
             (100, 64, 128), (128, 32, 64), (64, 21, 5), (1, 130, 200)]


@pytest.mark.parametrize("i,shape", list(enumerate(MM_SHAPES)))
def test_mm_int8_matches_jax(i, shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
    b = rng.integers(-5000, 5000, (n,)).astype(np.int32) if i % 2 else None
    kw = dict(shift=(0, 3, 7)[i % 3], relu=i % 4 < 2)
    want = np.asarray(jmm.mm_int8(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        interpret=True, **kw))
    got = tmm.mm_int8(torch.from_numpy(x), torch.from_numpy(w),
                      None if b is None else torch.from_numpy(b), **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_mm_int8_raw_int32_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _int8(rng, (16, 32)), _int8(rng, (32, 16))
    b = rng.integers(-5000, 5000, (16,)).astype(np.int32)
    want = np.asarray(jmm.mm_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  relu=True, out_int8=False, interpret=True))
    got = tmm.mm_int8(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), relu=True, out_int8=False)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("xv,wv,k,out_int8,want", [
    (-128, -128, 131_073, False, -2147467264),
    (-128, 127, 132_200, True, 127)])
def test_mm_int8_ref_wraps_as_jax_does(xv, wv, k, out_int8, want):
    """Past 2^31 the int32 accumulator wraps in the JAX reference; the plain
    version wraps too (a float-to-int32 cast would saturate)."""
    from repro.kernels.mm_int8.ref import mm_int8_ref as jax_ref
    x = np.full((1, k), xv, np.int8)
    w = np.full((k, 1), wv, np.int8)
    jax_out = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w),
                                 out_int8=out_int8))
    got = tmm.mm_int8(torch.from_numpy(x), torch.from_numpy(w),
                      out_int8=out_int8)
    assert jax_out.item() == want
    assert got.dtype == (torch.int8 if out_int8 else torch.int32)
    np.testing.assert_array_equal(got.numpy(), jax_out)


def test_mm_int8_saturates():
    x = torch.full((8, 128), 127, dtype=torch.int8)
    w = torch.full((128, 8), 127, dtype=torch.int8)
    out = tmm.mm_int8(x, w)
    assert int(out.max()) == 127 and int(out.min()) == 127


# -- K2 cascade_mlp and the K1 chain ------------------------------------------------

CHAINS = [[16, 64, 32, 32, 32, 5], [16, 128, 64, 64, 64, 5], [21, 32, 5],
          [32, 128, 64, 5], [64, 32, 128, 32, 5], [16, 64, 64, 128, 32, 5]]


@pytest.mark.parametrize("dims", CHAINS, ids=lambda d: "-".join(map(str, d)))
def test_cascade_mlp_matches_jax(dims):
    rng = np.random.default_rng(len(dims) * 7 + dims[1])
    ref, port, xq = _models(rng, dims, 96)
    want = np.asarray(jcm.cascade_mlp(jnp.asarray(xq), ref, interpret=True))
    got = tcm.cascade_mlp(torch.from_numpy(xq), port)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dims", CHAINS[:2], ids=lambda d: "-".join(map(str, d)))
def test_mlp_unfused_matches_jax(dims):
    rng = np.random.default_rng(3)
    ref, port, xq = _models(rng, dims, 64)
    want = np.asarray(jcm.mlp_unfused(jnp.asarray(xq), ref, interpret=True))
    got = tcm.mlp_unfused(torch.from_numpy(xq), port)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tcm.cascade_mlp(torch.from_numpy(xq), port).numpy())


def test_cascade_mlp_flattened_batch_matches_jax_vmap():
    """The server's MLP path: (B, M, F) flattened to (B*M, F) rows for one
    launch equals the JAX server's vmap over events."""
    rng = np.random.default_rng(11)
    ref, port, _ = _models(rng, [16, 64, 32, 5], 64)
    x = _int8(rng, (4, 8, 16), -60, 60)
    want = np.asarray(jax.vmap(lambda e: jcm.cascade_mlp(e, ref, interpret=True))(
        jnp.asarray(x)))
    got = tcm.cascade_mlp(torch.from_numpy(x).reshape(32, 16), port)
    np.testing.assert_array_equal(got.reshape(4, 8, -1).numpy(), want)


# -- K3 deepsets ------------------------------------------------------------------

@pytest.mark.parametrize("m,agg", [(32, "mean"), (32, "sum"), (16, "mean"),
                                   (7, "mean"), (21, "sum"), (1, "mean"),
                                   # the edges of the CUDA kernel's 16-row
                                   # tiles and 32-row passes
                                   (15, "mean"), (17, "sum"), (33, "mean"),
                                   (64, "sum")])
def test_deepsets_matches_jax(m, agg):
    rng = np.random.default_rng(m)
    phi, rho, tphi, trho = _deepsets_models(rng, 21, [32, 32], [10], max(m, 8))
    x = _int8(rng, (m, 21), -40, 40)
    want = np.asarray(jcm.deepsets(jnp.asarray(x), phi, rho, agg=agg,
                                   interpret=True))
    got = tcm.deepsets(torch.from_numpy(x), tphi, trho, agg=agg)
    assert got.shape == (1, 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [32, 7])
def test_deepsets_batch_matches_jax_vmap(m):
    """One launch over (B, M, F) equals the JAX server's vmap of the
    one-event kernel; outputs keep the JAX shape (B, 1, n_out)."""
    rng = np.random.default_rng(100 + m)
    phi, rho, tphi, trho = _deepsets_models(rng, 21, [32, 32, 32], [32, 10], 32)
    x = _int8(rng, (5, m, 21), -40, 40)
    want = np.asarray(jax.vmap(lambda e: jcm.deepsets(e, phi, rho,
                                                      interpret=True))(
        jnp.asarray(x)))
    got = tcm.deepsets(torch.from_numpy(x), tphi, trho)
    assert got.shape == want.shape == (5, 1, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_deepsets_ref_matches_jax_ref():
    rng = np.random.default_rng(9)
    phi, rho, tphi, trho = _deepsets_models(rng, 21, [32, 32], [10], 16)
    x = _int8(rng, (16, 21), -40, 40)
    want = np.asarray(jcm.deepsets_ref(jnp.asarray(x), phi, rho))
    np.testing.assert_array_equal(
        tcm.deepsets_ref(torch.from_numpy(x), tphi, trho).numpy(), want)
    with pytest.raises(ValueError, match="power-of-two"):
        tcm.deepsets_ref(torch.from_numpy(x[:7]), tphi, trho)


@pytest.mark.parametrize("m", [7, 3, 21])
def test_deepsets_ref_sum_takes_any_set_size_as_jax_does(m):
    """'sum' shifts the set sum by floor(log2 M) for any M, as the JAX
    package's deepsets_ref does; 'mean' still refuses an M that is not a
    power of two, in both packages."""
    rng = np.random.default_rng(40 + m)
    phi, rho, tphi, trho = _deepsets_models(rng, 21, [32, 32], [10], 32)
    x = _int8(rng, (m, 21), -40, 40)
    want = np.asarray(jcm.deepsets_ref(jnp.asarray(x), phi, rho, agg="sum"))
    got = tcm.deepsets_ref(torch.from_numpy(x), tphi, trho, agg="sum")
    np.testing.assert_array_equal(got.numpy(), want)
    batch = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    assert torch.equal(tcm.deepsets_ref(batch, tphi, trho, agg="sum")[0], got)
    with pytest.raises(ValueError, match="power-of-two"):
        tcm.deepsets_ref(torch.from_numpy(x), tphi, trho, agg="mean")
    with pytest.raises(AssertionError):
        jcm.deepsets_ref(jnp.asarray(x), phi, rho, agg="mean")


# -- the packed layout the CUDA kernels read ---------------------------------------

@pytest.mark.parametrize("dims,no_bias", [([16, 64, 32, 5], ()),
                                           ([21, 20, 13, 37, 10], (1,)),
                                           ([21, 32, 32, 32], ()),
                                           ([32, 32, 10], ())],
                         ids=["jsc-m-like", "odd-widths-one-without-bias",
                              "deepsets-32-phi", "deepsets-32-rho"])
def test_packed_mma_chain_holds_every_layer(dims, no_bias):
    """The tensor-core layout K2 and K3 read, read back through ``meta`` as
    the kernels read it: w^T with N padded to a multiple of 8 and K to a
    multiple of 32 (row stride K + 16 bytes), each bias padded to N8, zero
    everywhere past the layer; packed once per model."""
    rng = np.random.default_rng(2)
    _, port, _ = _models(rng, dims, 32)
    port = QuantizedMLP(port.e_in, tuple(
        dataclasses.replace(l, bias_q=None) if i in no_bias else l
        for i, l in enumerate(port.layers)))
    pc = tcm.packed_mma_chain(port)
    assert tcm.packed_mma_chain(port) is pc
    meta, w, b = list(pc.meta), pc.w.numpy(), pc.b.numpy()
    n_layers, w_bytes, b_count = meta[:3]
    assert (n_layers, w_bytes, b_count) == (len(dims) - 1, w.size, b.size)
    assert w_bytes % 16 == 0 and b_count % 4 == 0
    assert pc.stride % 16 == 0 and (pc.stride // 4) % 8 == 4
    assert pc.stride >= max(-(-k // 32) * 32 for k in dims[:-1])
    for i, l in enumerate(port.layers):
        k, kp, ks, n, np_, shift, relu, has_bias, w_off, b_off = \
            meta[3 + 10 * i: 13 + 10 * i]
        assert (k, n) == tuple(l.w_q.shape)
        assert kp == -(-k // 32) * 32 and np_ == -(-n // 8) * 8
        assert ks == kp + 16 and w_off % 16 == 0
        wt = w[w_off: w_off + np_ * ks].reshape(np_, ks)
        np.testing.assert_array_equal(wt[:n, :k].T, l.w_q.numpy())
        assert not wt[:n, k:].any() and not wt[n:].any()
        assert (shift, bool(relu)) == (l.shift, l.relu)
        assert bool(has_bias) == (i not in no_bias)
        if has_bias:
            np.testing.assert_array_equal(b[b_off: b_off + n], l.bias_q.numpy())
            assert not b[b_off + n: b_off + np_].any()


def test_deepsets_pack_holds_both_chains():
    """K3's one contiguous copy: phi's and rho's packed weights and biases,
    then each chain's layer records padded to 16 bytes; another rho gives
    another pack. (K3's launch plan holds it, once per (phi, rho) pair:
    ``tests/test_torch_cuda.py``.)"""
    rng = np.random.default_rng(3)
    _, _, tphi, trho = _deepsets_models(rng, 21, [32, 20, 32], [32, 10], 16)
    pack = tcm.ops._deepsets_pack(tphi, trho)
    assert torch.equal(tcm.ops._deepsets_pack(tphi, trho), pack)
    assert pack.dtype == torch.uint8 and pack.numel() % 16 == 0
    pp, pr = tcm.packed_mma_chain(tphi), tcm.packed_mma_chain(trho)
    parts = [pp.w.view(torch.uint8), pr.w.view(torch.uint8),
             pp.b.view(torch.uint8), pr.b.view(torch.uint8)]
    off = 0
    for part in parts:
        assert torch.equal(pack[off: off + part.numel()], part)
        off += part.numel()
    for pc in (pp, pr):
        ints = -(-(len(pc.meta) - 3) // 4) * 4
        records = pack[off: off + 4 * ints].view(torch.int32).numpy()
        np.testing.assert_array_equal(records[:len(pc.meta) - 3], pc.meta[3:])
        assert not records[len(pc.meta) - 3:].any()
        off += 4 * ints
    assert off == pack.numel()
    _, _, _, other = _deepsets_models(rng, 21, [32], [32, 10], 16)
    other_pack = tcm.ops._deepsets_pack(tphi, other)
    assert other_pack.numel() != pack.numel() or \
        not torch.equal(other_pack, pack)


# -- the launch plans' model-only ints ----------------------------------------

def _port_chain(dims, relu_last=False, seed=0):
    """A CPU-packed chain of the port's own PTQ."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 0.4, (dims[i], dims[i + 1]))
          for i in range(len(dims) - 1)]
    bs = [rng.normal(0, 0.1, (d,)) for d in dims[1:]]
    return tquant.quantize_mlp(ws, bs, [True] * (len(ws) - 1) + [relu_last],
                               rng.normal(0, 1, (8, dims[0])))


def _per_call_k3(pp, pr, f, fixed, batch):
    """K3's shared-memory arithmetic as its wrapper did it on every call
    before the launch plan: (stride, xraw, per_warp, events, smem)."""
    stride = max(pp.stride, pr.stride)
    xraw = -(-(16 * f + 36) // 16) * 16
    per_warp = 2 * 16 * stride + 2 * xraw + 4 * (-(-pp.widths[-1] // 8) * 8)
    events = min(2, max(batch, 1),
                 (_build.MAX_SMEM_BYTES - fixed) // (2 * per_warp))
    return stride, xraw, per_warp, events, fixed + events * 2 * per_warp


@pytest.mark.parametrize("dims,stride,smem", [
    ([16, 64, 32, 32, 32, 5], 80, 14880),        # jsc-m, the benchmark's K2
    ([1792, 64], 1808, 231680)])                  # the widest one-layer chain
def test_k2_plan_ints_are_the_per_call_formulas(dims, stride, smem):
    """The stride and shared memory a K2 plan holds equal what the wrapper
    computed on every call before (the packed bytes and each of the block's
    two warps' two 16-row buffers), for jsc-m and for the widest one-layer
    chain ``_check_smem`` admits (K 32 wider is refused)."""
    pc = tcm.packed_mma_chain(_port_chain(dims))
    assert pc.stride == stride
    assert tcm.ops._cascade_smem(pc) == smem
    assert smem == pc.smem_bytes + 2 * tcm.ops.BLOCK_ROWS * pc.stride
    tcm.ops._check_smem(smem)
    if len(dims) == 2:
        wider = tcm.packed_mma_chain(_port_chain([dims[0] + 32, dims[1]]))
        with pytest.raises(ValueError, match="cannot be fused"):
            tcm.ops._check_smem(tcm.ops._cascade_smem(wider))


@pytest.mark.parametrize("phi_dims,rho_dims,want", [
    ([21, 32, 32, 32], [32, 32, 10], (48, 384, 2432, 7696, 2, 17424)),
    ([21, 1536, 32], [32, 10], (1552, 384, 50560, 130624, 1, 231744))],
    ids=["deepsets-32", "one-event-a-block"])
def test_k3_plan_ints_are_the_per_call_formulas(phi_dims, rho_dims, want):
    """The stride, x staging, per-warp bytes, event cap and shared memory a
    K3 plan holds equal the per-call arithmetic of the wrapper before the
    plan, at every batch: for deepsets-32 (the benchmark's K3) and a pair
    whose block holds one event."""
    phi = _port_chain(phi_dims, relu_last=True)
    rho = _port_chain(rho_dims, seed=1)
    pp, pr = tcm.packed_mma_chain(phi), tcm.packed_mma_chain(rho)
    pack = tcm.ops._deepsets_pack(phi, rho)
    lay = tcm.ops._deepsets_layout(pp, pr, pack.numel())
    stride, xraw, per_warp, pack_bytes, events, smem = want
    assert (lay.stride, lay.xraw, lay.per_warp, lay.pack_bytes, lay.events) \
        == (stride, xraw, per_warp, pack_bytes, events)
    for batch in (1, 2, 3, 1000):
        ev = min(lay.events, batch)                 # what the C side takes
        ev_smem = lay.pack_bytes + ev * tcm.ops.EVENT_WARPS * lay.per_warp
        assert (lay.stride, lay.xraw, lay.per_warp, ev, ev_smem) \
            == _per_call_k3(pp, pr, phi_dims[0], pack.numel(), batch)
        if batch >= 2:
            assert ev_smem == smem


def test_k3_plan_refuses_a_pair_above_one_block():
    phi = _port_chain([21, 1568, 32], relu_last=True)
    rho = _port_chain([32, 10], seed=1)
    pp, pr = tcm.packed_mma_chain(phi), tcm.packed_mma_chain(rho)
    with pytest.raises(ValueError, match="cannot be fused"):
        tcm.ops._deepsets_layout(pp, pr,
                                 tcm.ops._deepsets_pack(phi, rho).numel())


def test_fusion_legality_rejects_an_oversized_chain():
    with pytest.raises(ValueError, match="cannot be fused"):
        tcm.ops._check_smem(_build.MAX_SMEM_BYTES + 1)
    tcm.ops._check_smem(_build.MAX_SMEM_BYTES)
