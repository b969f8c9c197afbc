"""Training state across the two packages and through the port's driver,
on the CPU: twins of tests/test_system.py::TestTrainResume, the port's
``launch.train`` end to end (run, checkpoint, resume), checkpoints and
training state carried across both ways, the reference's chunked attention
branches under autograd, K5's refusal of a gradient, remat, and the prefill
and decode step builders.

Tolerances are tests/test_torch_train.py's (LOSS_RTOL, GNORM_RTOL,
PARAM_ATOL, with their reasons there). The chunked attention branches are
held at ATTN_TOL = 2e-2 of the largest |value| (output and gradients; q, k
and v in bf16, so one bf16 ulp of rounding apart is 2^-8 of a value).
Checkpoints and restored states are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import configs as rcfg
from repro import optim as jopt
from repro.distributed.steps import make_train_step as jstep
from repro.models import attention as jA
from repro.models import build as jbuild
from repro_torch import ckpt, optim
from repro_torch import configs as pcfg
from repro_torch._tree import leaves
from repro_torch.distributed import steps
from repro_torch.kernels.flash_attn import flash_attention, flash_mha
from repro_torch.launch import train
from repro_torch.models import (attention as tA, build, params_from_numpy,
                                params_to_numpy, state_from_numpy,
                                state_to_reference, to_reference)
from test_torch_train import (LOSS_RTOL, OCFG, PARAM_ATOL, _batch,
                              _jax_batch, _port_batch, _rel, _same_params)

ATTN_TOL = 2e-2


def _equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _ckpt_tree(cfg, model, st):
    return to_reference(cfg, model.params()), state_to_reference(cfg, st)


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

class TestTrainResume:
    def test_auto_resume_continues_from_checkpoint(self, tmp_path):
        name = "xlstm-350m"
        cfg = pcfg.get_reduced(name)
        model = build(cfg, device="cpu", remat=True,
                      weight_dtype=torch.float32)
        ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        step_fn = steps.make_train_step(cfg, ocfg, device="cpu")
        opt = optim.init(model.params())
        batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
                 "labels": torch.ones((2, 16), dtype=torch.int32)}
        for _ in range(3):
            model, opt, _ = step_fn(model, opt, batch)
        ckpt.save(str(tmp_path), 3, _ckpt_tree(cfg, model, opt))
        # "crash": restore into the same structure
        (p2, o2), step, _ = ckpt.restore(str(tmp_path),
                                         _ckpt_tree(cfg, model, opt))
        assert step == 3 and int(o2.step) == 3
        _equal_trees(p2, to_reference(cfg, model.params()))
        _equal_trees(o2, state_to_reference(cfg, opt))
        model2 = params_from_numpy(cfg, p2, device="cpu", remat=True,
                                   weight_dtype=torch.float32)
        opt2 = state_from_numpy(cfg, o2, device="cpu")
        # training continues from the restored state, as from the live one
        m3, o3, m = step_fn(model2, opt2, batch)
        _, _, want = step_fn(model, opt, batch)
        assert int(o3.step) == 4 and np.isfinite(float(m["loss"]))
        assert float(m["loss"]) == float(want["loss"])
        _equal_trees(m3.params(), model.params())

    def test_uncommitted_checkpoint_invisible(self, tmp_path):
        d = ckpt.save(str(tmp_path), 1, {"w": torch.ones((4,))})
        (tmp_path / "step_000000001" / ckpt.COMMIT).unlink()
        assert d.endswith("step_000000001")
        assert ckpt.latest_step(str(tmp_path)) is None


def _ref_steps(cfg, params, n, seed0=0):
    """The reference's compiled step from ``params`` and a fresh state,
    ``n`` times on batches seeded seed0, seed0 + 1, ...: each step's
    (params, state, metrics)."""
    f = jax.jit(jstep(cfg, jopt.AdamWConfig(**OCFG)))
    p, st, out = params, jopt.init(params), []
    for i in range(n):
        p, st, m = f(p, st, _jax_batch(_batch(cfg, seed0 + i)))
        out.append((p, st, m))
    return out


class TestCarryAcross:
    name = "granite-8b"

    def _setup(self):
        cfg = rcfg.get_reduced(self.name)
        params = jbuild(cfg).init(jax.random.PRNGKey(0))
        return cfg, pcfg.get_reduced(self.name), params

    def test_the_port_continues_the_reference(self, tmp_path):
        """The reference trains 2 steps and checkpoints (params, state);
        the port restores that checkpoint and takes the third step, held
        against the reference's third step."""
        cfg, pc, params = self._setup()
        ref = _ref_steps(cfg, params, 3)
        jp2, js2, _ = ref[1]
        jckpt.save(str(tmp_path), 2, (jp2, js2))
        shape = params_to_numpy(pc, build(pc, device="cpu"))
        like = (shape, optim.AdamWState(step=0, mu=shape, nu=shape))
        (p, s), step, _ = ckpt.restore(str(tmp_path), like)
        assert step == 2
        model = params_from_numpy(pc, p, device="cpu", remat=True,
                                  weight_dtype=torch.float32)
        st = state_from_numpy(pc, s, device="cpu")
        assert int(st.step) == 2
        for a, b in zip(jax.tree.leaves(params_to_numpy(pc, model)),
                        jax.tree.leaves(jp2)):
            assert np.array_equal(a, np.asarray(b))
        step3 = steps.make_train_step(pc, optim.AdamWConfig(**OCFG),
                                      device="cpu")
        model, st, m = step3(model, st, _port_batch(_batch(cfg, 2)))
        jp3, js3, jm3 = ref[2]
        assert int(st.step) == 3
        assert _rel(m["loss"], jm3["loss"]) <= LOSS_RTOL
        _same_params(model, pc, jp3)

    def test_the_reference_continues_the_port(self, tmp_path):
        """The port trains 2 steps from the reference's init and
        checkpoints in the reference's format; the reference restores it
        with its own ``restore`` and takes the third step, held against the
        port's third step."""
        cfg, pc, params = self._setup()
        model = params_from_numpy(pc, jax.tree.map(np.asarray, params),
                                  device="cpu", remat=True,
                                  weight_dtype=torch.float32)
        step = steps.make_train_step(pc, optim.AdamWConfig(**OCFG),
                                     device="cpu")
        st = optim.init(model.params())
        for i in range(2):
            model, st, _ = step(model, st, _port_batch(_batch(cfg, i)))
        ckpt.save(str(tmp_path), 2, _ckpt_tree(pc, model, st))
        (jp, js), jstep_n, _ = jckpt.restore(
            str(tmp_path), (params, jopt.init(params)))
        assert jstep_n == 2 and int(js.step) == 2
        for a, b in zip(jax.tree.leaves(jp),
                        jax.tree.leaves(params_to_numpy(pc, model))):
            assert np.array_equal(np.asarray(a), b)
        jp3, _, jm3 = jax.jit(jstep(cfg, jopt.AdamWConfig(**OCFG)))(
            jp, js, _jax_batch(_batch(cfg, 2)))
        model, st, m = step(model, st, _port_batch(_batch(cfg, 2)))
        assert _rel(m["loss"], jm3["loss"]) <= LOSS_RTOL
        _same_params(model, pc, jp3)

    def test_a_bf16_state_carries_across_bit_for_bit(self):
        """AdamW moments in bf16 (``moment_dtype``), reference layout ->
        port -> reference layout, each leaf's bits kept."""
        cfg, pc, params = self._setup()
        js = jopt.init(params, jnp.bfloat16)
        js = js._replace(mu=jax.tree.map(
            lambda a: (a + 0.5).astype(jnp.bfloat16), params))
        st = state_from_numpy(pc, jax.tree.map(np.asarray, js), device="cpu")
        assert all(t.dtype == torch.bfloat16 for t in leaves(st.mu))
        back = state_to_reference(pc, st)
        for a, b in zip(jax.tree.leaves(back.mu), jax.tree.leaves(js.mu)):
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  np.asarray(b).view(np.int16))


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def _argv(tmp, steps_, *extra):
    return ["--device", "cpu", "--steps", str(steps_), "--batch", "2",
            "--seq", "32", "--ckpt-every", "100", "--log-every", "1",
            "--ckpt-dir", str(tmp), *extra]


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    """Run 1 trains 4 steps and checkpoints at its end; run 2 (6 steps)
    resumes from step 4 with exactly run 1's (params, opt_state), trains
    2 more and commits step 6."""
    r1 = train.main(_argv(tmp_path, 4))
    assert r1["resumed_from"] is None and r1["saved_steps"] == [4]
    assert len(r1["losses"]) == 4 and np.isfinite(r1["losses"]).all()
    cfg = r1["model"].cfg
    saved = _ckpt_tree(cfg, r1["model"], r1["opt_state"])
    r2 = train.main(_argv(tmp_path, 6))
    assert r2["resumed_from"] == 4 and r2["last_step"] == 6
    _equal_trees(r2["restored"], saved)
    assert len(r2["losses"]) == 2 and np.isfinite(r2["losses"]).all()
    assert r2["saved_steps"] == [6] and ckpt.latest_step(str(tmp_path)) == 6
    assert int(r2["opt_state"].step) == 6
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "stragglers observed" in out


def test_launch_train_resumes_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference wrote of its own (params, state) resumes
    in the port's driver: restored bit for bit, then trained on."""
    name = "granite-8b"
    cfg = rcfg.get_reduced(name)
    params = jbuild(cfg).init(jax.random.PRNGKey(3))
    jp, js, _ = _ref_steps(cfg, params, 1)[0]
    jckpt.save(str(tmp_path), 1, (jp, js))
    r = train.main(_argv(tmp_path, 2, "--arch", name))
    assert r["resumed_from"] == 1 and len(r["losses"]) == 1
    for a, b in zip(jax.tree.leaves(r["restored"]),
                    jax.tree.leaves((jp, js))):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["whisper-base", "qwen2-vl-72b"])
def test_launch_train_refuses_encdec_and_stub_frontends(name):
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--arch", name, "--steps", "1"])


# ---------------------------------------------------------------------------
# attention under autograd
# ---------------------------------------------------------------------------

def _bf16_pair(rng, shape):
    a = np.asarray(jnp.asarray(rng.normal(0, 1, shape), jnp.bfloat16)
                   .astype(jnp.float32))
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _close_rel(got, want):
    g = got.float().detach().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= ATTN_TOL * np.abs(w).max()


@pytest.mark.parametrize("window", [None, 20])
def test_sdpa_q_chunked_matches_jax_with_its_gradients(window):
    """The reference's chunked branch at a forced small chunk (3 x 3 tiles
    of 16), GQA with 2 KV heads, with the window and without: the output
    and the gradients of q, k and v for one cotangent."""
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, s) for s in (
        (2, 48, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    jct, tct = _bf16_pair(rng, (2, 48, 64))
    f = lambda q, k, v: jA._sdpa_q_chunked(q, k, v, window, 2, 16, 16)
    want, vjp = jax.vjp(f, jq, jk, jv)
    wgrads = vjp(jct)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    got = tA._sdpa_q_chunked(tq, tk, tv, window, 2, 16, 16)
    _close_rel(got, want)
    ggrads = torch.autograd.grad(got, (tq, tk, tv), tct)
    for g, w in zip(ggrads, wgrads):
        _close_rel(g, w)
    # the same function as the dense branch
    dense = tA._sdpa(tq, tk, tv, tA._causal_mask(48, 48, window), 2)
    _close_rel(got, jnp.asarray(dense.float().detach().numpy()))


def test_mla_chunked_branch_matches_jax_with_its_gradients(monkeypatch):
    """MLA's chunked branch, forced at S = 48 (both packages'
    DENSE_ATTN_MAX_SEQ lowered to 16; q and kv chunks of 16): the output
    and the gradients of x and every weight."""
    cfg = rcfg.get_reduced("minicpm3-4b")
    from repro.models import transformer as jT
    mcfg = jT._mla_cfg(cfg)
    p = jA.mla_init(jax.random.PRNGKey(1), mcfg)
    rng = np.random.default_rng(6)
    jx, tx = _bf16_pair(rng, (2, 48, cfg.d_model))
    jct, tct = _bf16_pair(rng, (2, 48, cfg.d_model))
    monkeypatch.setattr(jA, "DENSE_ATTN_MAX_SEQ", 16)
    monkeypatch.setattr(tA, "DENSE_ATTN_MAX_SEQ", 16)
    want, vjp = jax.vjp(lambda p_, x_: jA.mla_attention(p_, x_, mcfg), p, jx)
    wp, wx = vjp(jct)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    for t in leaves(tp):
        t.requires_grad_(True)
    tx.requires_grad_(True)
    got = tA.mla_attention(tp, tx, tA.MLAConfig(**vars(mcfg)))
    _close_rel(got, want)
    grads = torch.autograd.grad(got, leaves(tp) + [tx], tct)
    for g, w in zip(grads, jax.tree.leaves(wp) + [wx]):
        _close_rel(g, w)
    monkeypatch.setattr(tA, "DENSE_ATTN_MAX_SEQ", 4096)
    dense = tA.mla_attention(tp, tx, tA.MLAConfig(**vars(mcfg)))
    _close_rel(dense, jnp.asarray(got.float().detach().numpy()))


def test_flash_attention_refuses_a_gradient():
    """K5 has no backward: both wrappers raise where grad mode is on and q,
    k or v requires grad; under no_grad or inference_mode they run."""
    q = torch.randn(1, 128, 2, 16)
    k = torch.randn(1, 128, 2, 16)
    for req in ("q", "k", "v"):
        args = [q.clone(), k.clone(), k.clone()]
        args["qkv".index(req)].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_mha(*args)
        flat = [a.transpose(1, 2).reshape(2, 128, 16) for a in args]
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(*flat)
        with torch.no_grad():
            flash_mha(*args)
        with torch.inference_mode():
            flash_mha(*args)
    flash_mha(q, k, k)


@pytest.mark.parametrize("name", ["granite-8b", "minicpm3-4b",
                                  "recurrentgemma-2b", "whisper-base"])
def test_training_attention_never_reaches_k5(name, monkeypatch):
    """A train step's forward runs the reference's attention functions:
    K5's wrapper is never called (it would raise), and remat changes no
    gradient (each group recomputed bit for bit)."""
    from repro_torch.models import encdec as tE
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return flash_mha(*a, **kw)

    monkeypatch.setattr(tA, "flash_mha", spy)
    monkeypatch.setattr(tE, "flash_mha", spy)
    cfg = pcfg.get_reduced(name)
    model = build(cfg, device="cpu", seed=2, remat=True,
                  weight_dtype=torch.float32)
    batch = _port_batch(_batch(cfg, 4))
    loss, _, g1 = steps.loss_and_grads(cfg, model, batch)
    model.remat = False
    _, _, g0 = steps.loss_and_grads(cfg, model, batch)
    assert calls == [] and bool(torch.isfinite(loss))
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)
    with torch.no_grad():
        model(batch["tokens"], batch["frames"]) if cfg.enc_layers else \
            model(batch["tokens"])
    assert calls


def test_mlstm_gradient_is_finite_where_the_reference_overflows():
    """xlstm with a chunk of 128 over 128 tokens: the reference's mLSTM
    exponentiates the decay above the diagonal and masks after, which
    overflows for a long chunk and turns the gradient into NaN; the port
    masks first, the same function. Held in f32 as test_torch_train.py
    holds xlstm (F32_DRIVEN): the same loss within LOSS_RTOL, and a finite
    gradient where the reference's is not."""
    import dataclasses
    from repro.distributed.steps import softmax_xent
    from test_torch_train import _bf16
    # one pattern group (7 mLSTM blocks and an sLSTM) is enough to overflow
    cut = dict(mlstm_chunk=128, n_layers=8)
    cfg = dataclasses.replace(rcfg.get_reduced("xlstm-350m"), **cut)
    pc = dataclasses.replace(pcfg.get_reduced("xlstm-350m"), **cut)
    jm = jbuild(cfg)
    params = jax.tree.map(_bf16, jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 128))

    def jloss(p):
        emb = p["embedding"]["emb"][jnp.asarray(toks)]
        return softmax_xent(jm.forward(p, None, embeds=emb)[0],
                            jnp.asarray(toks))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jg))
    model = params_from_numpy(pc, params, device="cpu",
                              weight_dtype=torch.float32)
    flat = leaves(model.params())
    for p in flat:
        p.requires_grad_(True)
    tt = torch.from_numpy(toks)
    loss = steps.softmax_xent(model(None, embeds=model.embedding["emb"][tt])[0],
                              tt)
    grads = torch.autograd.grad(loss, flat)
    assert _rel(loss.detach(), jl) <= LOSS_RTOL
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-14b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_prefill_and_decode_steps(name):
    """``make_prefill`` is the model's forward without a graph (K5's
    path); ``make_decode_step`` its decode step; both under inference
    mode, on a model trained one step and cast back to bf16."""
    cfg = pcfg.get_reduced(name)
    model = build(cfg, device="cpu", seed=1, remat=True,
                  weight_dtype=torch.float32)
    batch = _port_batch(_batch(cfg, 7))
    model, _, _ = steps.make_train_step(cfg, optim.AdamWConfig(**OCFG),
                                        device="cpu")(
        model, optim.init(model.params()), batch)
    serving = model.cast(torch.bfloat16)
    emb = serving.embedding["emb"]
    assert emb.dtype == torch.bfloat16 and not emb.requires_grad
    assert torch.equal(emb, model.embedding["emb"].to(torch.bfloat16))
    logits = steps.make_prefill(cfg, device="cpu")(serving, batch)
    assert logits.is_inference() and logits.shape[:2] == (2, 16)
    with torch.no_grad():
        want, _ = steps._forward(cfg, serving, batch)
    assert torch.equal(logits, want)
    if cfg.frontend == "vision_stub":
        return
    decode = steps.make_decode_step(cfg)
    tok = batch["tokens"][:, :1].long()
    if cfg.enc_layers:
        cache = serving.init_cache(batch["frames"], 8)
    else:
        cache = serving.init_cache(2, 8)
    lg, cache = decode(serving, tok, cache)
    assert lg.shape == (2, 1, cfg.vocab) and cache["pos"] == 1
    # the first position's logits, as tests/test_torch_lm.py holds decode
    assert float((lg - logits[:, :1]).abs().max()
                 / logits[:, :1].abs().max()) <= 0.02
