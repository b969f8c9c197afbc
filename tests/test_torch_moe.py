"""The port's mixture-of-experts layer (``models.moe``) against the JAX
package's, on the CPU.

The same numpy-seeded x and weights go through both ``moe_forward``s. The
routing is compared exactly: expert ids, the kept (expert, slot) of every
choice and the dropped count, against the reference's own routing lines
(``src/repro/models/moe.py:70-89``, evaluated with JAX below), in cases
where capacity drops choices and where it does not.

Tolerances, and why:
  * routing: exact (``==``). The router runs in f32 on both sides from the
    same f32 inputs; a near-tie between two experts' probabilities could
    still flip a pick, so each case first checks that its closest top-k
    margin is far above f32 rounding.
  * outputs: BF16_TOL = 2e-2 (rtol = atol) in bf16, F32_TOL = 2e-5 in f32:
    the expert products sum 64-128 terms in another order, and in bf16
    each side rounds h, the expert outputs and the combined sum, which may
    fall the other way by an ulp (2^-8 relative).
  * aux loss: F32_TOL, an f32 mean of the same routed fractions and
    probabilities.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as jM
from repro_torch.models import moe as tM

F32_TOL, BF16_TOL = 2e-5, 2e-2
D, FF = 32, 48

# (name, experts, top_k, capacity_factor, shared, groups, tokens a group)
CASES = [
    ("mixtral-like", 4, 2, 1.25, False, 2, 24),
    ("top2-drops", 4, 2, 0.5, False, 2, 24),
    ("top1-shared-drops", 8, 1, 0.5, True, 1, 40),
    ("top1-shared", 8, 1, 1.25, True, 3, 16),
]


def _params(rng, cfg: jM.MoEConfig):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.normal(0, d ** -0.5, (d, E)),
         "wg": rng.normal(0, d ** -0.5, (E, d, f)),
         "wu": rng.normal(0, d ** -0.5, (E, d, f)),
         "wd": rng.normal(0, f ** -0.5, (E, f, d))}
    if cfg.shared_expert:
        p["shared"] = {"wg": rng.normal(0, d ** -0.5, (d, f)),
                       "wu": rng.normal(0, d ** -0.5, (d, f)),
                       "wd": rng.normal(0, f ** -0.5, (f, d))}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _both(tree, dtype):
    """The tree in JAX (f32, as the reference keeps its weights) and in the
    port (the matrices in ``dtype``, the router f32, as the port holds
    them)."""
    jp = jax.tree.map(jnp.asarray, tree)

    def go(t, key=None):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        w = torch.from_numpy(t)
        return w if key == "router" else w.to(dtype)
    return jp, go(tree)


def _ref_routing(p, x, cfg: jM.MoEConfig):
    """The reference's routing, ``src/repro/models/moe.py:70-89`` line for
    line: (expert ids, slot, keep) as numpy, and the closest relative gap
    between the last picked and the first unpicked probability of a token
    (the near-tie check)."""
    G, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = jM._capacity(S, cfg)
    logits = jnp.einsum("gsd,de->gse", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, K)
    assign = jax.nn.one_hot(expert_ids, E, dtype=jnp.float32)
    assign_flat = assign.transpose(0, 2, 1, 3).reshape(G, K * S, E)
    pos_flat = (jnp.cumsum(assign_flat, axis=1) - assign_flat)
    keep_flat = (pos_flat < C) * assign_flat
    pos = pos_flat.reshape(G, K, S, E).transpose(0, 2, 1, 3)
    keep = keep_flat.reshape(G, K, S, E).transpose(0, 2, 1, 3)
    slot = np.asarray(jnp.sum(pos * assign, axis=-1)).astype(np.int64)
    kept = np.asarray(jnp.sum(keep, axis=-1)) > 0
    srt = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    margin = float(((srt[..., K - 1] - srt[..., K]) / srt[..., K - 1]).min())
    return np.asarray(expert_ids), slot, kept, margin


def _x(rng, g, s, dtype):
    jx = jnp.asarray(rng.normal(0, 1, (g, s, D)), getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,E,K,cf,shared,G,S", CASES,
                         ids=[c[0] for c in CASES])
def test_moe_forward_matches_jax(dtype, name, E, K, cf, shared, G, S):
    rng = np.random.default_rng(E * 100 + K * 10 + S)
    jcfg = jM.MoEConfig(d_model=D, d_ff=FF, n_experts=E, top_k=K,
                        capacity_factor=cf, shared_expert=shared)
    tcfg = tM.MoEConfig(**dataclasses.asdict(jcfg))
    jp, tp = _both(_params(rng, jcfg), getattr(torch, dtype))
    jx, tx = _x(rng, G, S, dtype)

    ids, slot, kept, margin = _ref_routing(jp, jx, jcfg)
    assert margin > 1e-4, f"a router near-tie (relative gap {margin:.2e})"
    r = tM.moe_route(tp, tx, tcfg)
    assert r.capacity == jM._capacity(S, jcfg)
    assert np.array_equal(r.expert_ids.numpy(), ids)
    assert np.array_equal(r.slot.numpy(), slot)
    assert np.array_equal(r.keep.numpy(), kept)
    assert r.dropped == int((~kept).sum())
    if "drops" in name:
        assert r.dropped > 0
    np.testing.assert_allclose(r.gates.sum(-1).numpy(), 1.0, rtol=1e-6)

    want, jaux = jM.moe_forward(jp, jx, jcfg)
    got, aux = tM.moe_forward(tp, tx, tcfg)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_TOL,
                               atol=F32_TOL)


def test_top1_gate_is_one_and_a_dropped_token_gets_only_the_shared_expert():
    """top-1 renormalizes its gate to 1.0; a token whose only choice was
    dropped gets the shared expert's output alone, as in the reference."""
    rng = np.random.default_rng(5)
    cfg = tM.MoEConfig(d_model=D, d_ff=FF, n_experts=8, top_k=1,
                       capacity_factor=0.5, shared_expert=True)
    _, tp = _both(_params(rng, cfg), torch.float32)
    x = torch.from_numpy(rng.normal(0, 1, (1, 40, D)).astype(np.float32))
    r = tM.moe_route(tp, x, cfg)
    assert torch.equal(r.gates, torch.ones_like(r.gates))
    dropped = (~r.keep[0, :, 0]).nonzero()[:, 0]
    assert len(dropped) > 0
    out, _ = tM.moe_forward(tp, x, cfg)
    from repro_torch.models.blocks import swiglu
    shared = swiglu(tp["shared"], x)
    assert torch.equal(out[0, dropped], shared[0, dropped])


def test_capacity_queues_choice_major():
    """GShard's priority: every first choice queues before any second
    choice, each in token order. Token 0's second choice and token 1's
    first choice both go to expert 1: the first choice takes slot 0."""
    cfg = tM.MoEConfig(d_model=2, d_ff=4, n_experts=2, top_k=2,
                       capacity_factor=0.25)
    # token 0 prefers expert 0, token 1 expert 1
    router = torch.tensor([[4.0, 0.0], [0.0, 4.0]])
    x = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    r = tM.moe_route({"router": router}, x, cfg)
    assert r.capacity == 1
    assert r.expert_ids.tolist() == [[[0, 1], [1, 0]]]
    assert r.slot.tolist() == [[[0, 1], [0, 1]]]
    assert r.keep.tolist() == [[[True, False], [True, False]]]
    assert r.dropped == 2


def test_moe_init_draws_an_expert_at_a_time_at_the_reference_scale():
    """The stacked weights at 1/sqrt(E) (the reference's ``_init`` on an
    (E, d, f) shape), in the asked dtype, the router f32; the same seed
    gives the same weights."""
    cfg = tM.MoEConfig(d_model=64, d_ff=256, n_experts=4, top_k=2,
                       shared_expert=True)
    p = tM.moe_init(torch.Generator().manual_seed(0), cfg,
                    dtype=torch.bfloat16, device="cpu")
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (64, 4)
    assert p["wg"].dtype == torch.bfloat16 and p["wg"].shape == (4, 64, 256)
    assert p["wd"].shape == (4, 256, 64)
    assert abs(float(p["wg"].float().std()) - 0.5) < 0.01
    assert set(p["shared"]) == {"wg", "wu", "wd"}
    again = tM.moe_init(torch.Generator().manual_seed(0), cfg,
                        dtype=torch.bfloat16, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in ("router", "wg", "wu",
                                                      "wd"))
    assert not torch.equal(p["wg"][0], p["wg"][1])


def test_routing_log_records_and_pins_the_routing():
    """``routing_log`` records each call's routing; pinning a call to its
    own picks changes nothing (bit for bit), and pinning it to other
    experts routes there, with the gates read from the call's own
    probabilities at those experts and renormalized."""
    rng = np.random.default_rng(7)
    cfg = tM.MoEConfig(d_model=D, d_ff=FF, n_experts=8, top_k=2,
                       capacity_factor=0.5)
    _, tp = _both(_params(rng, cfg), torch.float32)
    x = torch.from_numpy(rng.normal(0, 1, (1, 24, D)).astype(np.float32))
    want, _ = tM.moe_forward(tp, x, cfg)
    log = []
    with tM.routing_log(log):
        tM.moe_forward(tp, x, cfg)
    assert len(log) == 1 and log[0].dropped > 0
    assert torch.equal(log[0].expert_ids, tM.moe_route(tp, x, cfg).expert_ids)
    again = []
    with tM.routing_log(again, lambda i: (log[i].expert_ids, log[i].keep)):
        same, _ = tM.moe_forward(tp, x, cfg)
    assert torch.equal(same, want)
    other = (log[0].expert_ids + 1) % cfg.n_experts
    keep = torch.ones_like(log[0].keep)
    moved = []
    with tM.routing_log(moved, lambda i: (other, keep)):
        got, _ = tM.moe_forward(tp, x, cfg)
    r = tM.pinned(log[0], other, keep)
    assert torch.equal(r.expert_ids, other)
    np.testing.assert_allclose(r.gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    xs = x[0]
    ref = torch.zeros_like(xs)
    for k in range(cfg.top_k):
        for t in range(xs.shape[0]):
            e = int(other[0, t, k])
            h = F.silu(xs[t] @ tp["wg"][e]) * (xs[t] @ tp["wu"][e])
            ref[t] += r.gates[0, t, k] * (h @ tp["wd"][e])
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    assert tM._observer is None
