"""The port's float models and data against the JAX package's.

Float parameters carry across from JAX; forward, loss and one SGD step's
gradients agree within rtol 1e-5 / atol 1e-6 (float32 sums run in another
order in the two frameworks). Quantized models must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.models import deepsets as jds
from repro.models import mlp as jmlp
from repro_torch import data as tdata
from repro_torch.models import deepsets as tds
from repro_torch.models import mlp as tmlp
from test_torch_quant import assert_same_qmlp

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("seed", [0, 3])
def test_jet_batch_is_the_same_stream(seed):
    cfg_j = jdata.JetConfig(n_particles=8, n_features=5, n_classes=3, seed=seed)
    cfg_t = tdata.JetConfig(n_particles=8, n_features=5, n_classes=3, seed=seed)
    xj, yj = jdata.jet_batch(cfg_j, 16, 7)
    xt, yt = tdata.jet_batch(cfg_t, 16, 7)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    s = tdata.jet_stream(cfg_t, 4, start_seed=2)
    np.testing.assert_array_equal(next(s)[0], tdata.jet_batch(cfg_t, 4, 2)[0])


def _jet(n_particles, n_features, n_classes, batch=32):
    cfg = jdata.JetConfig(n_particles=n_particles, n_features=n_features,
                          n_classes=n_classes)
    return jdata.jet_batch(cfg, batch, 1)


def _grads_close(tmodel, t_loss, jgrads_flat):
    params = list(tmodel.parameters())
    grads = torch.autograd.grad(t_loss, params)
    assert len(grads) == len(jgrads_flat)
    for g, jg in zip(grads, jgrads_flat):
        np.testing.assert_allclose(g.numpy(), jg, **TOL)


def _flat_jax(params):
    """JAX params flattened in the port's parameter order (w, b per layer)."""
    if isinstance(params, dict):
        return _flat_jax(params["phi"]) + _flat_jax(params["rho"])
    return [np.asarray(a) for p in params for a in (p["w"], p["b"])]


def test_mlp_forward_loss_and_grads_match():
    params = jmlp.mlp_init(jax.random.key(0), 16, [64, 32, 5])
    x, y = _jet(8, 16, 5)
    model = tmlp.params_from_numpy(_np(params), device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(model(xt).detach().numpy(),
                               np.asarray(jmlp.mlp_forward(params, x)), **TOL)
    loss = tmlp.mlp_loss(model, xt, yt)
    jl, jg = jax.value_and_grad(jmlp.mlp_loss)(params, jnp.asarray(x),
                                                jnp.asarray(y))
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    _grads_close(model, loss, _flat_jax(jg))


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_deepsets_forward_loss_and_grads_match(agg):
    params = jds.deepsets_init(jax.random.key(1), 6, [16, 16], [16, 4])
    x, y = _jet(8, 6, 4)
    model = tds.params_from_numpy(_np(params), device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(
        model(xt, agg=agg).detach().numpy(),
        np.asarray(jds.deepsets_forward(params, x, agg=agg)), **TOL)
    np.testing.assert_allclose(
        model(xt[0], agg=agg).detach().numpy(),
        np.asarray(jds.deepsets_forward(params, x[0], agg=agg)), **TOL)
    loss = tds.deepsets_loss(model, xt, yt, agg=agg)
    jl, jg = jax.value_and_grad(
        lambda p, a, b: jds.deepsets_loss(p, a, b, agg=agg))(
        params, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    _grads_close(model, loss, _flat_jax(jg))


def test_mlp_init_is_he_scaled_and_seeded():
    a = tmlp.mlp_init(64, [32, 5], generator=torch.Generator().manual_seed(4),
                      device="cpu")
    b = tmlp.mlp_init(64, [32, 5], generator=torch.Generator().manual_seed(4),
                      device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.layers[0].w.detach().numpy()
    assert w.shape == (64, 32) and abs(w.std() - np.sqrt(2 / 64)) < 0.03
    assert not a.layers[0].b.detach().numpy().any()


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_to_quantized_matches(seed):
    params = jmlp.mlp_init(jax.random.key(seed), 16, [64, 32, 32, 32, 5])
    cfg = jdata.JetConfig(n_particles=16, n_features=16)
    xcal, _ = jdata.jet_batch(cfg, 64, 12345)
    model = tmlp.params_from_numpy(_np(params), device="cpu")
    assert_same_qmlp(tmlp.to_quantized(model, xcal),
                     jmlp.to_quantized(params, xcal))


@pytest.mark.parametrize("m", [32, 21])
def test_deepsets_to_quantized_matches(m):
    """Includes the padded-Mp calibration divisor at a set size that is not
    a power of two."""
    params = jds.deepsets_init(jax.random.key(m), 21, [32, 32, 32], [32, 10])
    cfg = jdata.JetConfig(n_particles=m, n_features=21, n_classes=10)
    xcal, _ = jdata.jet_batch(cfg, 64, 12345)
    model = tds.params_from_numpy(_np(params), device="cpu")
    tphi, trho = tds.to_quantized(model, xcal)
    jphi, jrho = jds.to_quantized(params, xcal)
    assert_same_qmlp(tphi, jphi)
    assert_same_qmlp(trho, jrho)
