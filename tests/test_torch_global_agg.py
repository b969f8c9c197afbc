"""The port's global aggregation (K4) against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX wrapper
runs its Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
INT8 is exact, so every comparison is equality. The CUDA kernels themselves
are held against the plain version in test_torch_cuda.py.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import global_agg as jga
from repro_torch.kernels import global_agg as tga

# tests/test_kernels.py::TestGlobalAgg's grid, plus sizes that are not a
# power of two (padded to one for 'mean').
MS = [1, 3, 4, 7, 8, 16, 32, 64, 100]
FS = [5, 32, 40, 64, 130]


def _int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,f", list(itertools.product(MS, FS)))
def test_global_agg_matches_jax(m, f):
    rng = np.random.default_rng(m + f)
    x = _int8(rng, (m, f))
    for op in ("sum", "mean"):
        outs = {impl: tga.global_agg(torch.from_numpy(x), op=op, impl=impl)
                for impl in tga.ops.IMPLS}
        for impl, got in outs.items():
            want = np.asarray(jga.global_agg(jnp.asarray(x), op=op, impl=impl,
                                             interpret=True))
            assert got.shape == (1, f)
            assert got.dtype == (torch.int32 if op == "sum" else torch.int8)
            np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(outs["mac"], outs["extract_add"])


def test_mean_divides_by_the_padded_set_size():
    """A column summing to -226 over M = 3 is divided by Mp = 4 and rounded
    half away from zero: -57, as the JAX package gives."""
    x = np.zeros((3, 2), np.int8)
    x[:, 0] = [-100, -100, -26]
    x[:, 1] = [2, 0, 0]
    want = np.asarray(jga.global_agg(jnp.asarray(x), op="mean", interpret=True))
    got = tga.global_agg(torch.from_numpy(x), op="mean")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[-57, 1]]


@pytest.mark.parametrize("m", [1, 2, 16, 64])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_global_agg_ref_matches_jax_ref(m, op):
    rng = np.random.default_rng(m)
    x = _int8(rng, (m, 48))
    want = np.asarray(jga.global_agg_ref(jnp.asarray(x), op=op))
    np.testing.assert_array_equal(
        tga.global_agg_ref(torch.from_numpy(x), op=op).numpy(), want)


def test_global_agg_ref_reduces_axis_minus_two():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_int8(rng, (3, 8, 10)))
    got = tga.global_agg_ref(x, op="mean")
    assert got.shape == (3, 1, 10)
    for b in range(3):
        assert torch.equal(got[b], tga.global_agg_ref(x[b], op="mean"))


def test_mean_ref_refuses_a_set_size_that_is_no_power_of_two():
    x = np.zeros((7, 4), np.int8)
    with pytest.raises(ValueError, match="power-of-two"):
        tga.global_agg_ref(torch.from_numpy(x), op="mean")
    with pytest.raises(AssertionError):
        jga.global_agg_ref(jnp.asarray(x), op="mean")


@pytest.mark.parametrize("kw", [dict(op="max"), dict(impl="vpu")])
def test_global_agg_refuses_unknown_options(kw):
    with pytest.raises(ValueError):
        tga.global_agg(torch.zeros((4, 8), dtype=torch.int8), **kw)


def test_global_agg_takes_int8_matrices_only():
    with pytest.raises(ValueError, match="int8"):
        tga.global_agg(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="int8"):
        tga.global_agg(torch.zeros((2, 4, 8), dtype=torch.int8))
