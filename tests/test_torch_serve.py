"""The port's serving runtime and driver against the JAX package's.

``JetServer(device="cpu")`` in every mode must serve outputs bit-identical
to the JAX ``JetServer(interpret=True)`` on the same quantized model.
"""
import jax
import numpy as np
import pytest

from repro.data import JetConfig, jet_batch
from repro.models import deepsets as jds
from repro.models import mlp as jmlp
from repro.serve import JetServer as JaxServer
from repro.serve import ServeStats as JaxStats
from repro_torch.launch import serve as tserve
from repro_torch.quant import QuantizedMLP
from repro_torch.serve import JetServer, ServeStats


def _quantize_inputs(x, e_in):
    return np.clip(np.round(x / 2.0 ** e_in), -128, 127).astype(np.int8)


def _deepsets(m, seed=0):
    params = jds.deepsets_init(jax.random.key(seed), 21, [32, 32], [16, 5])
    x, _ = jet_batch(JetConfig(n_particles=m, n_features=21, n_classes=5), 8, 1)
    qphi, qrho = jds.to_quantized(params, x)
    return (qphi, qrho), _quantize_inputs(x, qphi.e_in)


def _mlp(seed=0):
    params = jmlp.mlp_init(jax.random.key(seed), 16, [32, 16, 5])
    x, _ = jet_batch(JetConfig(n_particles=8, n_features=16), 8, 1)
    q = jmlp.to_quantized(params, x)
    return (q, None), _quantize_inputs(x, q.e_in)


CASES = [("deepsets", 32, "fused"), ("deepsets", 32, "ref"),
         ("deepsets", 32, "unfused"), ("deepsets", 7, "fused"),
         ("mlp", 8, "fused"), ("mlp", 8, "unfused"), ("mlp", 8, "ref")]


@pytest.mark.parametrize("kind,m,mode", CASES)
def test_server_matches_jax_server(kind, m, mode):
    (q, rho), xq = _deepsets(m) if kind == "deepsets" else _mlp()
    jax_srv = JaxServer(q, rho=rho, mode=mode, interpret=True, window_us=50.0)
    srv = JetServer(QuantizedMLP.from_arrays(q),
                    rho=None if rho is None else QuantizedMLP.from_arrays(rho),
                    mode=mode, device="cpu", window_us=50.0)
    try:
        for i in range(3):
            want = jax_srv.infer(xq[i])
            got = srv.infer(xq[i])
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    finally:
        jax_srv.close()
        srv.close()


def test_server_batches_requests_and_keeps_order():
    (q, rho), xq = _deepsets(8, seed=1)
    tq, trho = QuantizedMLP.from_arrays(q), QuantizedMLP.from_arrays(rho)
    one = JetServer(tq, rho=trho, device="cpu", window_us=0.0)
    srv = JetServer(tq, rho=trho, device="cpu", max_batch=8,
                    window_us=20_000.0)
    try:
        singles = [one.infer(x) for x in xq]
        reqs = [srv.submit(x) for x in xq]
        for r in reqs:
            assert r.event.wait(30)
        assert max(srv.stats.batch_sizes) > 1, "no batching happened"
        for r, s in zip(reqs, singles):
            np.testing.assert_array_equal(r.result, s)
            assert r.latency_us >= r.queue_wait_us >= 0
            assert r.t_submit <= r.t_dequeued <= r.t_start <= r.t_done
    finally:
        one.close()
        srv.close()


def test_failed_batch_raises_in_infer():
    """A batch that fails reaches its callers as an error (deepsets 'ref'
    needs a power-of-two set) and the worker keeps serving."""
    (q, rho), xq = _deepsets(7)
    srv = JetServer(QuantizedMLP.from_arrays(q),
                    rho=QuantizedMLP.from_arrays(rho), mode="ref",
                    device="cpu", window_us=0.0)
    try:
        with pytest.raises(RuntimeError, match="serving batch failed"):
            srv.infer(xq[0])
        with pytest.raises(RuntimeError):
            srv.infer(xq[1])
    finally:
        srv.close()


def test_server_rejects_unknown_mode():
    (q, rho), _ = _mlp()
    with pytest.raises(ValueError, match="mode"):
        JetServer(QuantizedMLP.from_arrays(q), mode="pallas", device="cpu")


@pytest.mark.parametrize("lat", [[5.0, 1.0, 3.0], list(range(1, 301))])
def test_serve_stats_match_jax(lat):
    ours, theirs = ServeStats(), JaxStats()
    for i, v in enumerate(lat):
        for s in (ours, theirs):
            s.record(float(i), i + v * 1e-6)
            s.batch_sizes.append(1 + i % 3)
    assert ours.summary() == theirs.summary()


def test_predict_uses_the_row_mean():
    scores = np.array([[10, 0, 0], [-20, 1, 0], [-20, 2, 0]], np.int8)
    assert tserve._predict(scores, 3) == 1          # mean [-10, 1, 0]
    assert tserve._predict(scores[None, :1], 3) == 0


@pytest.mark.parametrize("model,mode", [("deepsets-32", "fused"),
                                        ("jsc-m", "unfused")])
def test_launch_serve_runs_on_cpu(model, mode, capsys):
    rep = tserve.main(["--model", model, "--mode", mode, "--device", "cpu",
                       "--events", "8", "--train-steps", "2"])
    out = capsys.readouterr().out
    assert "INT8 acc" in out and "events/s" in out
    assert rep["device"] == "cpu" and rep["outputs"].dtype == np.int8
    assert rep["outputs"].shape[0] == 8 and len(rep["xq"]) == 8
    assert 0.0 <= rep["acc_int8"] <= 1.0 and 0.0 <= rep["acc_float"] <= 1.0
    assert rep["p99_us"] >= rep["p50_us"] > 0
    assert rep["dequeue_p50_us"] >= 0 and rep["window_p50_us"] >= 0


@pytest.mark.parametrize("models", [(None,), ("mlp", None), ("mlp", "mlp")])
def test_prepare_packs_nothing_on_cpu(models):
    """The serve layer's warm-up is a no-op for CPU models: the plain
    versions need no packed weights."""
    from repro_torch.kernels import cascade_mlp as tcm
    (q, _), _ = _mlp()
    tq = QuantizedMLP.from_arrays(q)
    args = [tq if m == "mlp" else None for m in models]
    tcm.prepare(*args)
    assert tq not in tcm.ops._packed
