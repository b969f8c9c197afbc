"""The port's training substrate (``optim``, the LM half of ``data``,
``ckpt``, ``distributed.ft``) against the JAX package's, on the CPU: twins
of tests/test_substrate.py's TestOptim, TestData and TestCkpt and of
tests/test_system.py's TestWatchdog.

Tolerances, and why:
  * The schedule, the clip and the bias corrections are f32 in both
    packages from the same int32 step; cos and pow may round an ulp apart
    between XLA and torch, so they are held at SCHED_RTOL = 1e-6 (8 ulps).
  * One AdamW update from the same state: UPDATE_RTOL = 1e-5 on params and
    moments; each element goes through a dozen f32 operations, any of
    which may round an ulp apart (an FMA on one side, the division order).
    A moment near 0 (where b1 * m + (1 - b1) * g cancels) is held to
    UPDATE_RTOL of its tree's largest value.
  * 300 steps on the quadratic: TRAJ_ATOL = 1e-5 absolute, from a start of
    2 to 5 (the ulps above compounded through Adam's normalization; near
    the minimum the params are ~1e-3, where a relative bound means
    nothing).
  * Checkpoints and token streams: exact (bit for bit, ``==``).
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import optim as jopt
from repro.data import BigramSampler as JBigram
from repro.data import LMDataConfig as JLMData
from repro.distributed.ft import StepWatchdog as JWatchdog
from repro.distributed.ft import WatchdogConfig as JWatchdogConfig
from repro_torch import ckpt, optim
from repro_torch.data import BigramSampler, LMDataConfig, Prefetcher, place
from repro_torch.distributed.ft import StepWatchdog, WatchdogConfig

SCHED_RTOL = 1e-6
UPDATE_RTOL = 1e-5
TRAJ_ATOL = 1e-5


def _j(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

class TestOptim:
    def _quad(self):
        params = {"a": torch.tensor([2.0, -3.0]), "b": torch.tensor(5.0)}

        def grad(p):
            return {"a": 2 * p["a"], "b": 2 * p["b"]}

        return params, grad

    def test_adamw_converges_on_quadratic(self):
        """The reference's own test, and its trajectory: 300 steps of both
        packages from the same start stay within TRAJ_ATOL."""
        params, grad = self._quad()
        cfg = dict(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=500)
        state = optim.init(params)
        jp = {"a": jnp.array([2.0, -3.0]), "b": jnp.array(5.0)}
        js = jopt.init(jp)
        jloss = lambda p: jnp.sum(p["a"] ** 2) + p["b"] ** 2
        update = jax.jit(lambda g, s, p: jopt.update(
            jopt.AdamWConfig(**cfg), g, s, p))
        for _ in range(300):
            params, state, _ = optim.update(optim.AdamWConfig(**cfg),
                                            grad(params), state, params)
            jp, js, _ = update(jax.grad(jloss)(jp), js, jp)
        assert float((params["a"] ** 2).sum() + params["b"] ** 2) < 1e-3
        assert int(state.step) == int(js.step) == 300
        for k in ("a", "b"):
            np.testing.assert_allclose(params[k].numpy(), _j(jp[k]),
                                       rtol=0, atol=TRAJ_ATOL)

    def test_clip_by_global_norm(self):
        g = {"x": torch.full((4,), 10.0)}
        clipped, norm = optim.clip_by_global_norm(g, 1.0)
        assert float(norm) == pytest.approx(20.0)
        assert float(optim.global_norm(clipped)) == pytest.approx(1.0,
                                                                  rel=1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_clip_matches_jax_and_keeps_dtypes(self, dtype):
        rng = np.random.default_rng(0)
        arrs = {"w": rng.normal(0, 3, (7, 5)), "v": [rng.normal(0, 1, (3,))]}
        jg = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)),
                          arrs)
        tg = jax.tree.map(lambda a: torch.from_numpy(_j(a)).to(
            getattr(torch, dtype)), jg)
        jc, jn = jopt.clip_by_global_norm(jg, 1.0)
        tc, tn = optim.clip_by_global_norm(tg, 1.0)
        assert float(tn) == pytest.approx(float(jn), rel=SCHED_RTOL)
        assert tc["w"].dtype == getattr(torch, dtype)
        for a, b in ((tc["w"], jc["w"]), (tc["v"][0], jc["v"][0])):
            np.testing.assert_allclose(a.float().numpy(), _j(b),
                                       rtol=SCHED_RTOL if dtype == "float32"
                                       else 2 ** -8)

    def test_schedule_warmup_and_decay(self):
        cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                min_lr_ratio=0.1)
        s = lambda i: float(optim.schedule(cfg, torch.tensor(i)))
        assert s(5) == pytest.approx(0.5)
        assert s(100) == pytest.approx(0.1)
        assert 0.1 < s(55) < 1.0

    @pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (20, 4),
                                              (100, 10_000)])
    def test_schedule_matches_jax_in_f32(self, warmup, total):
        kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total)
        steps = np.arange(0, total + 30, dtype=np.int32)
        got = optim.schedule(optim.AdamWConfig(**kw), torch.from_numpy(steps))
        want = jopt.schedule(jopt.AdamWConfig(**kw), jnp.asarray(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _j(want), rtol=SCHED_RTOL)

    @pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("clip", [1.0, None])
    def test_update_matches_jax(self, moment_dtype, clip):
        """Three updates from the same params, grads and moments: params,
        moments, lr and the grad norm within UPDATE_RTOL (a bf16 moment to
        one bf16 ulp); the params and moments are updated in place."""
        rng = np.random.default_rng(1)
        cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
                   moment_dtype=moment_dtype)
        shapes = {"emb": (11, 6), "layers": [{"w": (6, 6)}, {"w": (6,)}]}
        p0 = jax.tree.map(lambda s: rng.normal(0, 1, s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
        jp = jax.tree.map(jnp.asarray, p0)
        tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
        js = jopt.init(jp, getattr(jnp, moment_dtype))
        ts = optim.init(tp, moment_dtype)
        for i in range(3):
            g = jax.tree.map(lambda a: rng.normal(0, 2, a.shape).astype(
                np.float32), p0)
            jp, js, jm = jopt.update(jopt.AdamWConfig(**cfg),
                                     jax.tree.map(jnp.asarray, g), js, jp)
            before = tp["emb"]
            tp, ts, tm = optim.update(optim.AdamWConfig(**cfg), jax.tree.map(
                torch.from_numpy, g), ts, tp)
            assert tp["emb"] is before
            assert int(ts.step) == i + 1 and ts.step.dtype == torch.int32
            assert float(tm["lr"]) == pytest.approx(float(jm["lr"]),
                                                    rel=SCHED_RTOL)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=SCHED_RTOL)
            mtol = UPDATE_RTOL if moment_dtype == "float32" else 2 ** -8
            for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
                np.testing.assert_allclose(a.numpy(), _j(b), rtol=UPDATE_RTOL,
                                           atol=1e-7)
            for tree_t, tree_j in ((ts.mu, js.mu), (ts.nu, js.nu)):
                for a, b in zip(jax.tree.leaves(tree_t),
                                jax.tree.leaves(tree_j)):
                    assert a.dtype == getattr(torch, moment_dtype)
                    # b1 * m + (1 - b1) * g cancels where g turns: an
                    # element near 0 is held to the tree's scale.
                    w = _j(b)
                    np.testing.assert_allclose(a.float().numpy(), w,
                                               rtol=mtol,
                                               atol=mtol * np.abs(w).max())

    def test_update_refuses_moments_of_another_dtype(self):
        p = {"w": torch.ones(3)}
        st = optim.init(p, torch.float32)
        with pytest.raises(ValueError, match="moments"):
            optim.update(optim.AdamWConfig(moment_dtype="bfloat16"),
                         {"w": torch.ones(3)}, st, p)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

class TestData:
    def test_bigram_stream_entropy_floor(self):
        cfg = LMDataConfig(vocab=128, seq_len=64, branching=4)
        s = BigramSampler(cfg)
        x, y = next(s.stream(8))
        assert x.shape == (8, 64) and (y[:, :-1] == x[:, 1:]).all()

    @pytest.mark.parametrize("kw", [dict(), dict(vocab=128, seq_len=64,
                                                 branching=4, seed=3),
                                    dict(vocab=256000, seq_len=32, seed=1)])
    def test_bigram_stream_equals_jax(self, kw):
        port = BigramSampler(LMDataConfig(**kw))
        ref = JBigram(JLMData(**kw))
        assert (port.succ == ref.succ).all() and (port.w == ref.w).all()
        for (a, b), (c, d) in zip(
                zip(range(3), port.stream(4, start_seed=5)),
                zip(range(3), ref.stream(4, start_seed=5))):
            assert b[0].dtype == d[0].dtype == np.int32
            assert (b[0] == d[0]).all() and (b[1] == d[1]).all()

    def test_prefetcher_order_and_completion(self):
        it = iter([{"a": np.full((2,), i)} for i in range(5)])
        out = list(Prefetcher(it, depth=2))
        assert [int(b["a"][0]) for b in out] == list(range(5))

    def test_prefetcher_places_batches_on_a_device(self):
        it = iter([{"tokens": np.full((2, 3), i, np.int32), "none": None,
                    "pair": (np.zeros(2), torch.ones(1))} for i in range(3)])
        out = list(Prefetcher(it, device=torch.device("cpu")))
        assert [int(b["tokens"][0, 0]) for b in out] == [0, 1, 2]
        for b in out:
            assert isinstance(b["tokens"], torch.Tensor)
            assert b["tokens"].dtype == torch.int32 and b["none"] is None
            assert isinstance(b["pair"][0], torch.Tensor)
        assert place(np.arange(3), torch.device("cpu")).tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# ckpt
# ---------------------------------------------------------------------------

def _tree(v=0.0):
    return {"w": torch.full((4, 4), v), "opt": {"mu": torch.full((4, 4), v)}}


def _mixed_jax():
    """A reference-style (params, AdamWState) tree with an f32, an int32
    scalar, a bf16 and a list leaf."""
    rng = np.random.default_rng(7)
    params = {"embedding": {"emb": jnp.asarray(rng.normal(0, 1, (5, 3)),
                                               jnp.float32)},
              "tail": [{"w": jnp.asarray(rng.normal(0, 1, (3,)),
                                         jnp.float32)}]}
    mu = jax.tree.map(lambda a: (a * 3).astype(jnp.bfloat16), params)
    return (params, jopt.AdamWState(step=jnp.asarray(9, jnp.int32), mu=mu,
                                    nu=mu))


def _as_torch(tree):
    """The reference's (params, AdamWState) as the port's, leaf by leaf."""
    def one(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.asarray(a).copy())
    params, st = jax.tree.map(one, tree)
    return params, optim.AdamWState(*st)


def _bits(x):
    """The raw bytes of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x
                ).numpy().tobytes()
    return np.asarray(x).tobytes()


class TestCkpt:
    def test_roundtrip(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 7, _tree(3.0), extra={"loss": 1.5})
        tree, step, extra = ckpt.restore(d, _tree())
        assert step == 7 and extra["loss"] == 1.5
        assert float(tree["w"][0, 0]) == 3.0

    def test_uncommitted_invisible(self, tmp_path):
        d = str(tmp_path)
        ckpt.save(d, 1, _tree(1.0))
        ckpt.save(d, 2, _tree(2.0))
        os.remove(os.path.join(d, "step_000000002", ckpt.COMMIT))
        assert ckpt.latest_step(d) == 1
        tree, step, _ = ckpt.restore(d, _tree())
        assert step == 1 and float(tree["w"][0, 0]) == 1.0

    def test_retention(self, tmp_path):
        d = str(tmp_path)
        for s in range(5):
            ckpt.save(d, s, _tree(float(s)))
        ckpt.retain(d, keep=2)
        assert ckpt.latest_step(d) == 4
        assert sorted(os.listdir(d)) == ["step_000000003", "step_000000004"]
        tree, step, _ = ckpt.restore(d, _tree())
        assert step == 4

    def test_async_checkpointer(self, tmp_path):
        d = str(tmp_path)
        ac = ckpt.AsyncCheckpointer(d, keep=2)
        for s in (1, 2, 3):         # a fresh host tree each save
            ac.maybe_save(s, _tree(float(s)))
        ac.wait()
        assert ckpt.latest_step(d) == 3 and ac.saved_steps == [1, 2, 3]
        tree, _, _ = ckpt.restore(d, _tree())
        assert float(tree["w"][0, 0]) == 3.0

    def test_async_checkpointer_takes_host_leaves_as_they_are(
            self, tmp_path, monkeypatch):
        """``maybe_save`` owns the tree: the worker writes the caller's own
        host tensors, copied nowhere (``launch.train`` hands over a fresh
        copy in the reference's layout)."""
        written = {}
        monkeypatch.setattr(ckpt, "save", lambda d, step, tree, extra=None:
                            written.setdefault(step, tree))
        ac = ckpt.AsyncCheckpointer(str(tmp_path))
        live = _tree(1.0)
        ac.maybe_save(1, live)
        ac.wait()
        assert ac.saved_steps == [1]
        for got, want in ((written[1]["w"], live["w"]),
                          (written[1]["opt"]["mu"], live["opt"]["mu"])):
            assert got.data_ptr() == want.data_ptr()

    def test_restore_names_a_missing_leaf(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"w": torch.ones(2)})
        with pytest.raises(KeyError, match="x"):
            ckpt.restore(str(tmp_path), {"w": 0, "x": 0})
        with pytest.raises(FileNotFoundError):
            ckpt.restore(str(tmp_path / "none"), {"w": 0})

    def test_the_reference_checkpoint_restores_bit_for_bit(self, tmp_path):
        """The reference writes (params, AdamWState) with a bf16 moment; the
        port restores every leaf with its dtype and its bits."""
        d = str(tmp_path)
        tree = _mixed_jax()
        jckpt.save(d, 9, tree, extra={"k": 1})
        got, step, extra = ckpt.restore(d, _as_torch(tree))
        assert step == 9 and extra == {"k": 1}
        assert isinstance(got[1], optim.AdamWState)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert a.dtype == {"float32": torch.float32, "int32": torch.int32,
                               "bfloat16": torch.bfloat16}[str(b.dtype)]
            assert tuple(a.shape) == b.shape and _bits(a) == _bits(b)

    def test_the_port_writes_the_reference_format(self, tmp_path):
        """The same tree saved by both packages gives the same npz entries
        (keys, dtypes, bytes; a bf16 leaf as 2-byte raw values) and the same
        manifest; the reference restores the port's f32/int32 leaves, and
        its bf16 bytes read back as the reference's own."""
        tree = _mixed_jax()
        jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
        jdir = jckpt.save(jd, 3, tree)
        tdir = ckpt.save(td, 3, _as_torch(tree))
        def read(d, name):
            with open(os.path.join(d, name)) as f:
                return f.read()
        assert json.loads(read(jdir, "manifest.json")) == json.loads(
            read(tdir, "manifest.json"))
        assert read(jdir, "COMMIT") == read(tdir, "COMMIT")
        with np.load(os.path.join(jdir, "shard_p0.npz")) as a, \
                np.load(os.path.join(tdir, "shard_p0.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            assert "1__mu__embedding__emb" in b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes()
            assert b["1__mu__embedding__emb"].dtype == np.dtype("V2")
        params, _ = tree
        got, step, _ = jckpt.restore(td, (params, {"step": tree[1].step}))
        assert step == 3
        for a, b in zip(jax.tree.leaves(got[0]), jax.tree.leaves(params)):
            assert _bits(a) == _bits(b)
        with np.load(os.path.join(tdir, "shard_p0.npz")) as z:
            raw = z["1__mu__embedding__emb"].view(jnp.bfloat16)
        assert _bits(raw) == _bits(tree[1].mu["embedding"]["emb"])


# ---------------------------------------------------------------------------
# ft
# ---------------------------------------------------------------------------

class TestWatchdog:
    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_straggler_counted(self, pkg):
        wd_cls, cfg_cls = ((StepWatchdog, WatchdogConfig) if pkg == "port"
                           else (JWatchdog, JWatchdogConfig))
        wd = wd_cls(cfg_cls(straggler_factor=3.0, min_timeout_s=60.0))
        for _ in range(8):
            with wd.step():
                time.sleep(0.005)
        with wd.step():
            time.sleep(0.1)       # 20x median -> straggler
        assert wd.stragglers >= 1
        assert len(wd.times) == 9

    def test_hang_handler_fires(self):
        fired = []
        wd = StepWatchdog(WatchdogConfig(min_timeout_s=0.05),
                          on_hang=lambda: fired.append(1))
        with wd.step():
            time.sleep(0.15)
        assert fired

    def test_timeouts_equal_jax(self):
        """Same step times, same median, timeout and window in both."""
        kw = dict(grace_factor=4.0, min_timeout_s=0.001, window=4)
        a, b = StepWatchdog(WatchdogConfig(**kw)), JWatchdog(
            JWatchdogConfig(**kw))
        for t in (0.3, 0.1, 0.2, 0.5, 0.4, 0.05):
            a.times.append(t)
            b.times.append(t)
            del a.times[:-kw["window"]], b.times[:-kw["window"]]
            assert a.median() == b.median()
            assert a.timeout_s() == b.timeout_s()
