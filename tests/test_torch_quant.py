"""The port's quantization (repro_torch.quant) against the JAX package's
(repro.quant): integer results must be equal, not close."""
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro_torch import quant as tq


@pytest.mark.parametrize("shift", range(11))
def test_requantize_shift_matches(shift):
    rng = np.random.default_rng(shift)
    acc = rng.integers(-2**20, 2**20, 256).astype(np.int32)
    # exact halves and their neighbours on both signs, and the int8 edges
    half = (1 << shift) // 2
    acc[:6] = [half, -half, 3 * half, -3 * half, half - 1, -half - 1]
    acc[6:10] = [127 << shift, -128 << shift, (127 << shift) + half,
                 (-128 << shift) - half]
    got = tq.requantize_shift(torch.from_numpy(acc), shift)
    want = np.asarray(jq.requantize_shift(acc, shift))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_quantize_pow2_float64_near_half_steps(seed):
    """float64 values a hair off the rounding midpoints: the JAX package
    divides in float32, where they land on the midpoint and round to even."""
    rng = np.random.default_rng(seed)
    e = -int(rng.integers(3, 8))
    k = rng.integers(-120, 120, 200).astype(np.float64)
    x = (k + 0.5) * 2.0 ** e + rng.choice([-1, 1], 200) * 2.0 ** (e - 30)
    x[0] = 127.0 * 2.0 ** e          # fixes the scale exponent at e
    q, e_got = tq.quantize_pow2(x)
    q_want, e_want = jq.quantize_pow2(x)
    assert e_got == e_want
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_want))


@pytest.mark.parametrize("percentile", [100.0, 99.5])
def test_pow2_scale_exponent_matches(percentile):
    x = np.random.default_rng(4).normal(0, 3, (64, 16))
    assert (tq.pow2_scale_exponent(x, percentile=percentile)
            == jq.pow2_scale_exponent(x, percentile=percentile))


def _float_mlp(rng, dims, dtype):
    ws = [rng.normal(0, 0.4, (dims[i], dims[i + 1])).astype(dtype)
          for i in range(len(dims) - 1)]
    bs = [rng.normal(0, 0.1, (d,)).astype(dtype) for d in dims[1:]]
    bs[1] = None                      # a layer without bias
    relus = [True] * (len(ws) - 1) + [False]
    return ws, bs, relus, rng.normal(0, 1, (64, dims[0])).astype(dtype)


def assert_same_qmlp(port, ref):
    assert port.e_in == int(ref.e_in)
    assert len(port.layers) == len(ref.layers)
    for p, r in zip(port.layers, ref.layers):
        np.testing.assert_array_equal(p.w_q.numpy(), np.asarray(r.w_q))
        assert (p.bias_q is None) == (r.bias_q is None)
        if p.bias_q is not None:
            np.testing.assert_array_equal(p.bias_q.numpy(), np.asarray(r.bias_q))
            assert p.bias_q.dtype == torch.int32
        assert (p.shift, p.relu, p.e_w, p.e_out) == (r.shift, r.relu, r.e_w,
                                                     r.e_out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_mlp_matches(dtype, seed):
    rng = np.random.default_rng(seed)
    args = _float_mlp(rng, [16, 64, 32, 5], dtype)
    assert_same_qmlp(tq.quantize_mlp(*args), jq.quantize_mlp(*args))


def test_quantize_mlp_act_exponents_match():
    args = _float_mlp(np.random.default_rng(2), [21, 32, 10], np.float32)
    assert_same_qmlp(tq.quantize_mlp(*args, act_exponents=[-3, -2]),
                     jq.quantize_mlp(*args, act_exponents=[-3, -2]))


def test_from_arrays_carries_the_jax_model_across():
    args = _float_mlp(np.random.default_rng(3), [16, 32, 32, 5], np.float32)
    ref = jq.quantize_mlp(*args)
    port = tq.QuantizedMLP.from_arrays(ref)
    assert_same_qmlp(port, ref)
    again = tq.QuantizedMLP.from_arrays(port)
    assert_same_qmlp(again, ref)
    assert again is not port


def test_dequantize_roundtrip_within_one_step():
    x = np.random.default_rng(5).normal(0, 2.5, (32, 32))
    q, e = tq.quantize_pow2(x)
    np.testing.assert_array_equal(
        tq.dequantize_pow2(q, e).numpy(),
        np.asarray(jq.dequantize_pow2(jq.quantize_pow2(x)[0], e)))
    assert np.abs(tq.dequantize_pow2(q, e).numpy() - x).max() <= 2.0 ** e


def test_quantized_mlp_to_moves_every_tensor_once():
    args = _float_mlp(np.random.default_rng(6), [8, 8, 4], np.float32)
    q = tq.quantize_mlp(*args)
    assert q.to("cpu") is q
    moved = q.to("meta")
    assert all(l.w_q.device.type == "meta" for l in moved.layers)
    assert all(l.bias_q is None or l.bias_q.device.type == "meta"
               for l in moved.layers)


def test_quantized_linear_rejects_bad_tensors():
    with pytest.raises(ValueError):
        tq.QuantizedLinear(w_q=torch.zeros((2, 2), dtype=torch.int32),
                           bias_q=None, shift=0, relu=False, e_w=0, e_out=0)
    with pytest.raises(ValueError):
        tq.QuantizedLinear(w_q=torch.zeros((2, 2), dtype=torch.int8),
                           bias_q=torch.zeros(3, dtype=torch.int32), shift=0,
                           relu=False, e_w=0, e_out=0)
