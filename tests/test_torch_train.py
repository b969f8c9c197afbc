"""The port's train step (``distributed.steps.make_train_step``: the models
under autograd, remat, the loss, AdamW) against the JAX package's, on the
CPU, for all ten archs (the two MoE archs in tests/test_torch_train_moe.py): a
twin of tests/test_arch_smoke.py::test_train_step_reduces_loss, which holds
each arch's step to the reference's own step on the same weights and
batch; and a twin of
tests/test_distributed.py::TestAccumEquivalence.

The weights are the JAX model's init, carried across with
``params_from_numpy(weight_dtype=torch.float32)`` (the reference's param
dtype); both packages take one AdamW step (lr 1e-3, warmup 2, clip 1.0) on
the same numpy-seeded batch (B = 2, S = 16; whisper's frames and qwen2-vl's
embeds as bf16 values).

Tolerances, and why:
  * loss and ce: LOSS_RTOL = 2e-3 relative. Both packages compute in bf16
    with f32 norms, softmax and logits; the products and elementwise
    chains round an ulp apart here and there (XLA fuses them), which moves
    the token-mean loss by ~1e-4 to 1e-3 of itself.
  * the gradient's global norm: GNORM_RTOL = 2e-2 relative, the same
    rounding carried back through every layer.
  * each leaf's gradient: LEAF_GRAD_RTOL = 0.1, the worst leaf's
    ||g_port - g_ref|| / ||g_ref|| (f64 norms over the leaf), against
    ``jax.grad`` of the reference's train loss on the same weights and
    batch. Measured on the CPU (this file run as a script prints them):
    the worst leaf of each bf16 arch 1.18e-2 (granite) to 3.53e-2
    (llama4's shared expert; recurrentgemma's conv 3.05e-2), the bf16
    rounding of the products carried back; xlstm in f32 4.1e-5. A leaf
    whose gradient is lost scores 1, one reversed 2, so the
    bound holds each leaf to its reference where the norms and the params
    cannot (test_leaf_check_fails_a_lost_or_reversed_gradient).
  * the params after the step: PARAM_ATOL = 2.5 x lr absolute, the
    reference's own bound in TestAccumEquivalence: Adam's first update is
    sign-like (mhat / sqrt(vhat) ~ +-1), so a gradient element near 0 that
    rounds to the other sign moves its param by up to 2 x lr.
  * The MoE archs (mixtral, llama4) are held to the reference run op by op
    (``jax.disable_jit()``), as tests/test_torch_lm.py holds their forward:
    compiled, XLA rounds the router's input otherwise and a near-tie flips
    an expert.
  * xlstm (F32_DRIVEN) is held in f32, as tests/test_torch_lm.py holds its
    forward: in bf16 its reduced model amplifies one ulp ~30-fold over its
    16 blocks (measured here: the bf16 steps' grad norms 7.6e-2 apart, the
    losses 6.5e-3). Both packages feed the f32 embedding rows of the
    tokens (gathered inside the loss, so the embedding still gets its
    gradient) with every weight rounded to a bf16 value first, and take
    their optimizer's update from the gradient; the step's other parts are
    the same code as every other arch's. The reference fails its own
    "loss falls" test on xlstm, so xlstm's twin compares against the
    reference's step and does not assert that the loss falls.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfg
from repro import optim as jopt
from repro.distributed.steps import make_train_step as jstep
from repro.distributed.steps import softmax_xent as jxent
from repro.models import build as jbuild
from repro_torch import configs as pcfg
from repro_torch import optim
from repro_torch._tree import flatten_with_paths, leaves, unflatten
from repro_torch.distributed import steps
from repro_torch.models import (params_from_numpy, params_to_numpy,
                                to_reference)

B, S = 2, 16
LOSS_RTOL, GNORM_RTOL = 2e-3, 2e-2
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
PARAM_ATOL = 2.5 * OCFG["lr"]
LEAF_GRAD_RTOL = 0.1
F32_DRIVEN = ("xlstm-350m",)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _batch(cfg, seed=0, b=B):
    """The reference's batch for ``cfg`` (test_arch_smoke's inputs, with
    random tokens and labels), as numpy."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        out["embeds"] = _bf16(rng.normal(0, 1, (b, S, cfg.d_model)))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    if cfg.enc_layers:
        out["frames"] = _bf16(rng.normal(0, 1, (b, 8, cfg.d_model)))
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                           else jnp.int32) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)).to(
        torch.bfloat16 if v.dtype == np.float32 else torch.int32)
        for k, v in batch.items()}


def _ref_mode(cfg):
    return jax.disable_jit() if cfg.n_experts else contextlib.nullcontext()


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _same_params(model, cfg, want):
    got = params_to_numpy(cfg, model)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0,
                                   atol=PARAM_ATOL)


def _ref_grads(cfg, jm, jp, batch):
    """``jax.grad`` of the reference's train loss (its
    ``make_train_step``'s ``loss_fn``: ce + 1e-2 * aux) at ``jp``."""
    jb = _jax_batch(batch)

    def loss(p):
        if cfg.enc_layers:
            logits, aux = jm.forward(p, jb["tokens"], jb["frames"])
        elif cfg.frontend == "vision_stub":
            logits, aux = jm.forward(p, None, embeds=jb["embeds"])
        else:
            logits, aux = jm.forward(p, jb["tokens"])
        return jxent(logits, jb["labels"]) + 1e-2 * aux

    with _ref_mode(cfg):
        f = jax.grad(loss)
        return (f if cfg.n_experts else jax.jit(f))(jp)


def _port_grads(pc, model, grads):
    """The port's gradients (one a leaf of ``model.params()``) in the
    reference's layout: (path, f64 array) a leaf, in JAX's order."""
    tree = to_reference(pc, unflatten(model.params(), grads))
    return [("/".join(p), g.double().numpy())
            for p, g in flatten_with_paths(tree)]


def _worst_leaf(got, want):
    """(||g - w|| / ||w||, path) of the worst leaf; a leaf whose reference
    gradient is 0 scores 0 only if the port's is 0 too."""
    want = flatten_with_paths(want)
    assert [p for p, _ in got] == ["/".join(p) for p, _ in want]
    errs = []
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w, np.float64)
        d, n = np.linalg.norm(g - w), np.linalg.norm(w)
        errs.append((d / n if n else (0.0 if d == 0 else np.inf), path))
    return max(errs)


def _same_grads(got, want):
    err, path = _worst_leaf(got, want)
    assert err <= LEAF_GRAD_RTOL, (path, err)


def _pair(name):
    cfg = rcfg.get_reduced(name)
    jm = jbuild(cfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if name in F32_DRIVEN:
        params = jax.tree.map(_bf16, params)
    pc = pcfg.get_reduced(name)
    pm = params_from_numpy(pc, params, device="cpu", remat=True,
                           weight_dtype=torch.float32)
    return cfg, jm, jax.tree.map(jnp.asarray, params), pc, pm


def _f32_step(cfg, jm, jp, pc, pm, batch):
    """F32_DRIVEN: each package's loss on the f32 embedding rows of the
    tokens, its gradient, and its AdamW update; also both gradients."""
    toks, labels = batch["tokens"], batch["labels"]

    def jloss(p):
        logits, aux = jm.forward(p, None, embeds=p["embedding"]["emb"][toks])
        ce = jxent(logits, labels)
        return ce + 1e-2 * aux, ce

    (jl, jce), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    jp2, _, jmet = jopt.update(jopt.AdamWConfig(**OCFG), jg, jopt.init(jp),
                               jp)
    params = pm.params()
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    tt = torch.from_numpy(toks).long()
    logits, aux = pm(None, embeds=pm.embedding["emb"][tt])
    ce = steps.softmax_xent(logits, torch.from_numpy(labels))
    loss = ce + 1e-2 * aux
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    _, _, met = optim.update(optim.AdamWConfig(**OCFG),
                             unflatten(params, grads), optim.init(params),
                             params)
    met.update(loss=loss.detach(), ce=ce.detach())
    return (jl, jce, jmet["grad_norm"], jp2), met, (grads, jg)


#: The MoE archs, held op by op in tests/test_torch_train_moe.py (the
#: reference's op-by-op start-up alone takes ~20 s of a worker).
MOE = tuple(n for n in rcfg.ARCH_NAMES if rcfg.get_reduced(n).n_experts)


@pytest.mark.parametrize("name", [n for n in rcfg.ARCH_NAMES
                                  if n not in MOE])
def test_train_step_matches_jax(name):
    check_train_step(name)


def check_train_step(name):
    """One step of both packages on the same weights and batch: loss, ce,
    the grad norm, every leaf's gradient and every param within the
    module's tolerances; the port's loss on the same batch falls after its
    step (but xlstm's, see the module docstring)."""
    cfg, jm, jp, pc, pm = _pair(name)
    batch = _batch(cfg)
    if name in F32_DRIVEN:
        (jl, jce, jgn, jp2), met, (grads, jg) = _f32_step(cfg, jm, jp, pc,
                                                          pm, batch)
    else:
        jg = _ref_grads(cfg, jm, jp, batch)
        with _ref_mode(cfg):
            f = jstep(cfg, jopt.AdamWConfig(**OCFG))
            if not cfg.n_experts:
                f = jax.jit(f)
            jp2, _, jmet = f(jp, jopt.init(jp), _jax_batch(batch))
        jl, jce, jgn = jmet["loss"], jmet["ce"], jmet["grad_norm"]
        step = steps.make_train_step(pc, optim.AdamWConfig(**OCFG),
                                     device="cpu")
        pb = _port_batch(batch)
        before, _, grads = steps.loss_and_grads(pc, pm, pb)
        before = float(before)
        _same_grads(_port_grads(pc, pm, grads), jg)
        pm, st, met = step(pm, optim.init(pm.params()), pb)
        assert int(st.step) == 1
        assert float(met["loss"]) == before
        assert float(steps.loss_and_grads(pc, pm, pb)[0]) < before
    for k in ("loss", "ce", "grad_norm"):
        assert met[k].dtype == torch.float32 and bool(torch.isfinite(met[k]))
    assert _rel(met["loss"], jl) <= LOSS_RTOL
    assert _rel(met["ce"], jce) <= LOSS_RTOL
    assert _rel(met["grad_norm"], jgn) <= GNORM_RTOL
    if name in F32_DRIVEN:
        _same_grads(_port_grads(pc, pm, grads), jg)
    _same_params(pm, pc, jp2)
    assert not any(p.requires_grad for p in pm.parameters())


@functools.lru_cache(maxsize=None)
def _grads_pair(name):
    """(the port's gradients in the reference's layout, the reference's)
    for ``name``'s twin (xlstm F32_DRIVEN)."""
    cfg, jm, jp, pc, pm = _pair(name)
    batch = _batch(cfg)
    if name in F32_DRIVEN:
        _, _, (grads, jg) = _f32_step(cfg, jm, jp, pc, pm, batch)
    else:
        jg = _ref_grads(cfg, jm, jp, batch)
        grads = steps.loss_and_grads(pc, pm, _port_batch(batch))[2]
    return _port_grads(pc, pm, grads), jg


@pytest.mark.parametrize("how", ["lost", "reversed"])
@pytest.mark.parametrize("name,leaf", [
    ("recurrentgemma-2b", "tail/0/rglru/lam"),
    ("recurrentgemma-2b", "final_norm/scale"),
    ("xlstm-350m", "groups/b7/core/rz/w")])
def test_leaf_check_fails_a_lost_or_reversed_gradient(name, leaf, how):
    """The per-leaf check of the twins passes on the port's gradients and
    fails once one small leaf's gradient is lost (zeros, as
    ``loss_and_grads`` hands out for a leaf the graph does not reach) or
    reversed: RG-LRU's lam, a norm scale, an sLSTM recurrent gate; the
    loss, the global norm and the one-step params would not see it."""
    got, want = _grads_pair(name)
    _same_grads(got, want)
    i = [p for p, _ in got].index(leaf)
    bad = list(got)
    bad[i] = (leaf, np.zeros_like(got[i][1]) if how == "lost"
              else -got[i][1])
    with pytest.raises(AssertionError, match=leaf):
        _same_grads(bad, want)


def test_accum_matches_full_batch():
    """The twin of TestAccumEquivalence (granite reduced, B = 4, no clip):
    the port's accum=2 step equals its accum=1 step (loss within 1e-5
    relative, the reference's bound; params within PARAM_ATOL) and the
    reference's accum=2 step (the module's tolerances)."""
    name = "granite-8b"
    cfg = rcfg.get_reduced(name)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4, clip_norm=None)
    params = jax.tree.map(np.asarray,
                          jbuild(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    jp = jax.tree.map(jnp.asarray, params)
    jp2, _, jm = jax.jit(jstep(cfg, jopt.AdamWConfig(**ocfg), accum=2))(
        jp, jopt.init(jp), _jax_batch(batch))
    pc = pcfg.get_reduced(name)
    out = {}
    for accum in (1, 2):
        pm = params_from_numpy(pc, params, device="cpu",
                               weight_dtype=torch.float32)
        step = steps.make_train_step(pc, optim.AdamWConfig(**ocfg),
                                     accum=accum, device="cpu")
        out[accum] = step(pm, optim.init(pm.params()), _port_batch(batch))
    (m1, _, r1), (m2, _, r2) = out[1], out[2]
    assert float(r2["loss"]) == pytest.approx(float(r1["loss"]), rel=1e-5)
    for a, b in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    assert _rel(r2["loss"], jm["loss"]) <= LOSS_RTOL
    assert _rel(r2["grad_norm"], jm["grad_norm"]) <= GNORM_RTOL
    _same_params(m2, pc, jp2)
    with pytest.raises(ValueError, match="split"):
        steps.make_train_step(pc, optim.AdamWConfig(), accum=3,
                              device="cpu")(m2, optim.init(m2.params()),
                                            _port_batch(batch))


if __name__ == "__main__":
    # The readings behind LEAF_GRAD_RTOL, on the CPU:
    #   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_train.py
    for arch in rcfg.ARCH_NAMES:
        print(arch, _worst_leaf(*_grads_pair(arch)))
