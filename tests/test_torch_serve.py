"""The port's serving runtime and driver against the JAX package's.

``JetServer(device="cpu")`` in every mode must serve outputs bit-identical
to the JAX ``JetServer(interpret=True)`` on the same quantized model.
"""
import gc

import jax
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("frozen_before", [False, True])
def test_serving_window_freezes_the_heap_and_counts_full_collections(
        frozen_before):
    """`launch.serve`'s serving window collects and freezes the heap, counts
    the full collections that still run inside it, and unfreezes the heap
    after it, an earlier freeze too, so that nothing stays out of
    collection."""
    if frozen_before:
        gc.freeze()
    try:
        with tserve._serving_window(torch.device("cpu")) as window:
            assert gc.get_freeze_count() > 0
            gc.collect()
        assert gc.get_freeze_count() == 0
        assert window["full_collections"] == 1 and window["collect_ms"] > 0
        assert window["cuda_mallocs"] is None
    finally:
        gc.unfreeze()


@pytest.mark.parametrize("argv", [["--model", "jsc-m"],
                                  ["--mix", "deepsets-32,jsc-m",
                                   "--replicas", "2"]])
def test_launch_serve_reports_its_serving_window(argv):
    rep = tserve.main(argv + ["--device", "cpu", "--events", "8",
                              "--train-steps", "2"])
    window = rep["serving_window"]
    assert window["collect_ms"] > 0 and window["full_collections"] >= 0
    assert window["cuda_mallocs"] is None
    assert gc.get_freeze_count() == 0


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


def _spy(monkeypatch, module):
    """Records the layer lists ``module.fused_chain_time_s`` is called with."""
    seen = []
    real = module.fused_chain_time_s

    def spy(layers, **kw):
        seen.append([(l.M, l.K, l.N, l.bytes_per_elem) for l in layers])
        return real(layers, **kw)
    monkeypatch.setattr(module, "fused_chain_time_s", spy)
    return seen


@pytest.mark.parametrize("kind", ["deepsets", "mlp"])
def test_modeled_latency_uses_the_jax_servers_shapes(kind, monkeypatch):
    """The same LayerShape list as the JAX server's (M = phi's input width
    for DeepSets, 64 rows for an MLP), on the H100 model; fusion wins."""
    from repro.core import tpu_model
    from repro_torch.core import h100_model
    (q, rho), _ = _deepsets(32) if kind == "deepsets" else _mlp()
    jax_seen = _spy(monkeypatch, tpu_model)
    ours_seen = _spy(monkeypatch, h100_model)
    jax_srv = JaxServer(q, rho=rho, interpret=True)
    srv = JetServer(QuantizedMLP.from_arrays(q),
                    rho=None if rho is None else QuantizedMLP.from_arrays(rho),
                    device="cpu")
    try:
        jax_srv.modeled_latency_us()
        mdl = srv.modeled_latency_us()
    finally:
        jax_srv.close()
        srv.close()
    assert len(jax_seen) == len(ours_seen) == 1
    assert ours_seen == jax_seen
    assert set(mdl) == {"fused_us", "unfused_us", "speedup"}
    assert mdl["speedup"] == mdl["unfused_us"] / mdl["fused_us"] > 1.0


def _observed_server(make, xq):
    """Serves ``xq`` one event at a time through a server whose observer
    records each request as it sees it, and raises on the second."""
    seen = []

    def on_done(r):
        seen.append((np.array(r.result), r.t_done is not None,
                     r.event.is_set()))
        if len(seen) == 2:
            raise RuntimeError("a broken observer")
    srv = make(on_done)
    try:
        outs = [srv.infer(x) for x in xq]
    finally:
        srv.close()
    return seen, outs


@pytest.mark.parametrize("kind", ["deepsets", "mlp"])
def test_on_done_matches_jax_server(kind):
    """Called once per request, after its result and t_done are set and
    before its waiter wakes; an observer that raises does not stop the
    worker."""
    (q, rho), xq = _deepsets(32) if kind == "deepsets" else _mlp()
    xq = xq[:4]
    tq = QuantizedMLP.from_arrays(q)
    trho = None if rho is None else QuantizedMLP.from_arrays(rho)
    want, want_out = _observed_server(lambda cb: JaxServer(
        q, rho=rho, interpret=True, window_us=0.0, on_done=cb), xq)
    got, got_out = _observed_server(lambda cb: JetServer(
        tq, rho=trho, device="cpu", window_us=0.0, on_done=cb), xq)
    assert len(got) == len(want) == len(xq)
    for (g, g_done, g_set), (w, w_done, w_set) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert (g_done, g_set) == (w_done, w_set) == (True, False)
    for g, w in zip(got_out, want_out):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model", ["deepsets-32", "jsc-m"])
def test_launch_serve_prints_modeled_and_dse_lines(model, capsys):
    """The single driver's two model lines: the H100 model's fused and
    per-layer times, and the VEK280 DSE, equal to the JAX package's."""
    from repro.core import dse as jdse
    from repro.launch.serve import SPECS as JSPECS
    rep = tserve.main(["--model", model, "--device", "cpu", "--events", "8",
                       "--train-steps", "20"])
    out = capsys.readouterr().out
    want = jdse.explore(JSPECS[model]())
    assert rep["dse_latency_ns"] == want.latency_ns
    assert rep["dse_summary"] == want.summary()
    assert (f"[serve] Tier-A μ-ORCA DSE on VEK280: {want.latency_ns:.0f} ns "
            f"({want.latency_ns / 1e3:.2f} us) — {want.summary()}") in out
    assert (f"[serve] modeled H100 latency: fused "
            f"{rep['modeled_fused_us']:.2f} us vs per-layer "
            f"{rep['modeled_unfused_us']:.2f} us") in out
    assert rep["modeled_speedup"] > 1.0
