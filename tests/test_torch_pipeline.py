"""The port's GPipe pipeline (``distributed.pipeline``) over a 4-rank
``("pp",)`` gloo mesh of CPU processes: 4 stages x 6 microbatches of
``tanh(x @ w)`` against the JAX package's ``pipeline`` over 4 host devices
(a subprocess that sets XLA_FLAGS before importing jax) on the same numpy
weights and input, and against the stages run one after another. Both
within 1e-5, the reference's own bound against sequential
(tests/test_pipeline.py): the same f32 products, summed by different
libraries. Every rank must return the last stage's output. The stacked
weights go in plain (every rank holds every row) and as a DTensor sharded
over the axis (each rank its own row).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import _torch_ranks

D, N_STAGES, N_MICRO, BATCH = 16, 4, 6, 12
TOL = 1e-5

REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.distributed.pipeline import pipeline, stack_stage_params
    from repro.launch.mesh import make_mesh
    d = np.load(sys.argv[1])
    mesh = make_mesh((4,), ("pp",))
    stages = [{"w": jnp.asarray(w)} for w in d["w"]]
    run = pipeline(lambda p, x: jnp.tanh(x @ p["w"]), mesh, "pp", %d)
    np.save(sys.argv[2], np.asarray(run(stack_stage_params(stages),
                                        jnp.asarray(d["x"]))))
""") % N_MICRO


def _inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (N_STAGES, D, D)).astype(np.float32)
    x = rng.normal(size=(BATCH, D)).astype(np.float32)
    return w, x


def _stage(p, x):
    return torch.tanh(x @ p["w"])


def _port(rank, world, w, x, sharded):
    from repro_torch.distributed.pipeline import pipeline, stack_stage_params
    from repro_torch.distributed.planner import shard_tensor
    from repro_torch.launch.mesh import NamedSharding, P, make_mesh
    mesh = make_mesh((world,), ("pp",), device="cpu")
    stacked = stack_stage_params([{"w": torch.from_numpy(a)} for a in w])
    if sharded:
        stacked = {"w": shard_tensor(stacked["w"],
                                     NamedSharding(mesh, P("pp")))}
    run = pipeline(_stage, mesh, "pp", N_MICRO)
    return run(stacked, torch.from_numpy(x)).numpy()


def test_pipeline_matches_the_reference_and_sequential(tmp_path):
    w, x = _inputs()
    inp, out = tmp_path / "in.npz", tmp_path / "out.npy"
    np.savez(inp, w=w, x=x)
    r = subprocess.run([sys.executable, "-c", REF, str(inp), str(out)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": "src",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout + r.stderr
    want = np.load(out)
    seq = torch.from_numpy(x)
    for a in w:
        seq = _stage({"w": torch.from_numpy(a)}, seq)
    for sharded in (False, True):
        got = _torch_ranks.run(_port, N_STAGES, tmp_path / str(sharded), w,
                               x, sharded)
        for rank, y in enumerate(got):
            assert y.shape == (BATCH, D)
            assert np.abs(y - want).max() <= TOL, (sharded, rank)
            assert np.abs(y - seq.numpy()).max() <= TOL, (sharded, rank)
