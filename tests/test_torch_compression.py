"""The port's int8 + error-feedback gradient compression
(``distributed.compression``) against the JAX package's.

  * ``compress`` / ``decompress`` on the same gradient and carried error:
    q, the scale and the new error equal the reference's with ``==`` (the
    same f32 operations: a power-of-two scale, a division by it, round half
    to even, a product by it).
  * error feedback: the reference's own test (tests/test_system.py), on the
    port.
  * ``compressed_psum`` over a one-rank group, as the reference's test runs
    it on a one-device ``pod`` mesh (within 1e-3 of the gradient, its
    bound), and over 4 gloo ranks against the reference's inside
    ``shard_map`` over 4 host devices (a subprocess): the mean gradient
    and each rank's new error equal with ``==`` (int32 sums are exact, and
    the scale and the final product are the same f32 operations).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import _torch_ranks
from repro_torch.distributed import compression

SHAPES = ((8, 16), (33,))


def _grads(world=4):
    rng = np.random.default_rng(5)
    return [[rng.normal(0, 10.0 ** -(2 + i), (world,) + s).astype(np.float32)
             for i, s in enumerate(SHAPES)] for _ in range(2)]


def test_compress_and_decompress_equal_the_reference():
    import jax.numpy as jnp
    from repro.distributed import compression as jc
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 300.0):
        g = rng.normal(0, scale, (64, 32)).astype(np.float32)
        e = rng.normal(0, scale / 100, (64, 32)).astype(np.float32)
        q, s, ne = compression.compress(torch.from_numpy(g),
                                        torch.from_numpy(e))
        jq, js, jne = jc.compress(jnp.asarray(g), jnp.asarray(e))
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        assert np.array_equal(ne.numpy(), np.asarray(jne))
        assert np.array_equal(compression.decompress(q, s).numpy(),
                              np.asarray(jc.decompress(jq, js)))


def test_error_feedback_preserves_signal():
    """Int8+EF compression: the accumulated decompressed signal tracks
    the accumulated true gradient (residual carried, not lost)."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(0, 1e-3, (128,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    s = torch.tensor(1.0)
    for _ in range(50):
        q, s, err = compression.compress(g_true, err)
        acc = acc + compression.decompress(q, s)
    resid = float(torch.max(torch.abs(acc - 50.0 * g_true)))
    assert resid <= float(s) + 1e-6


def _psum(rank, world, grads, errs):
    g = {"a": torch.from_numpy(grads[0][rank]),
         "b": torch.from_numpy(grads[1][rank])}
    e = {"a": torch.from_numpy(errs[0][rank]),
         "b": torch.from_numpy(errs[1][rank])}
    g2, e2 = compression.compressed_psum(g, e)
    return {k: v.numpy() for k, v in g2.items()}, \
        {k: v.numpy() for k, v in e2.items()}


def test_compressed_psum_single_axis(tmp_path):
    g = {"w": torch.arange(8, dtype=torch.float32) * 1e-2}
    grads = [[g["w"].numpy()[None]], [np.zeros((1, 1), np.float32)]]
    errs = [[np.zeros((1, 8), np.float32)], [np.zeros((1, 1), np.float32)]]
    (g2, _), = _torch_ranks.run(_psum, 1, tmp_path,
                                [grads[0][0], grads[1][0]],
                                [errs[0][0], errs[1][0]])
    np.testing.assert_allclose(g2["a"], g["w"].numpy(), atol=1e-3)


REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.distributed import compression
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    def f(g, e):
        g = jax.tree.map(lambda t: t[0], g)
        e = jax.tree.map(lambda t: t[0], e)
        g2, e2 = compression.compressed_psum(g, e, "pod")
        return g2, jax.tree.map(lambda t: t[None], e2)

    g = {k: jnp.asarray(d["g" + k]) for k in "ab"}
    e = {k: jnp.asarray(d["e" + k]) for k in "ab"}
    g2, e2 = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=(P(), P("pod")), check_vma=False))(g, e)
    np.savez(sys.argv[2], **{"g" + k: np.asarray(g2[k]) for k in "ab"},
             **{"e" + k: np.asarray(e2[k]) for k in "ab"})
""")


def test_compressed_psum_on_4_ranks_equals_the_reference(tmp_path):
    grads, errs = _grads()
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, ga=grads[0], gb=grads[1], ea=errs[0], eb=errs[1])
    r = subprocess.run([sys.executable, "-c", REF, str(inp), str(out)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": "src",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout + r.stderr
    want = np.load(out)
    got = _torch_ranks.run(_psum, 4, tmp_path, grads, errs)
    for rank, (g2, e2) in enumerate(got):
        for k in "ab":
            assert np.array_equal(g2[k], want["g" + k]), (rank, k)
            assert np.array_equal(e2[k], want["e" + k][rank]), (rank, k)
