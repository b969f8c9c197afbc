"""K6, the MoE layer's grouped kernel (``kernels.moe_grouped``), against its
plain version, the layer's loop over the held experts
(``models.moe._experts_loop``), on the card.

Every test here needs a CUDA device and nvcc: it is marked ``cuda`` and
skips where there is none. On a GPU machine:

    python -m pytest tests/test_torch_moe_grouped_cuda.py -q

The file imports no JAX. Both sides take the same dispatch (``moe.dispatch``
of one routing, its tables on the card) and the same bf16 x and stacks.

Tolerance, and why: the two round at different places. The loop's bf16
GEMMs (cuBLAS) round g, u, h and the down product to bf16; K6 rounds g, u
and h the same way but keeps the down product and its weight in f32, and
the two sum a token's choices in other orders (expert order, choice order).
So each is held to an f32 reference of the same function (g, u, SiLU and h
rounded to bf16 as both round them): K6's relative RMS error may not pass
the loop's by more than a quarter (plus 1e-4), and the two outputs lie
within 1% relative RMS of each other, some 4 bf16 ulps.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.distributed.steps import make_prefill
from repro_torch.kernels import _build, launches
from repro_torch.models import build
from repro_torch.models import moe as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rms(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _layer(dev, d, f, E, K, held, S, shared, seed=0, **route):
    """A MoE layer's config, weights and input on the card."""
    cfg = M.MoEConfig(d_model=d, d_ff=f, n_experts=E, top_k=K,
                      shared_expert=shared, held=held, **route)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = M.moe_init(gen, cfg, dtype=torch.bfloat16, device=dev)
    x = torch.randn((1, S, d), generator=gen, device=dev).bfloat16()
    return cfg, p, x


def _pinned(r, ids):
    """``r`` routed to ``ids`` (G, S, K), every choice kept."""
    return M.pinned(r, ids, torch.ones_like(ids, dtype=torch.bool))


def _reference(p, x, d, counts):
    """The layer's held experts in f32 from the same bf16 operands, with g,
    u, SiLU and h rounded to bf16 as both versions round them."""
    xf = x.reshape(-1, x.shape[-1]).float()
    out = torch.zeros_like(xf)
    start = 0
    bf = lambda t: t.bfloat16().float()
    for e, n in enumerate(counts):
        tok = d.token[start:start + n]
        xe = xf[tok]
        g, u = bf(xe @ p["wg"][e].float()), bf(xe @ p["wu"][e].float())
        h = bf(bf(F.silu(g)) * u)
        out.index_add_(0, tok, (h @ p["wd"][e].float())
                       * d.weight[start:start + n, None])
        start += n
    return out


def _both(p, x, cfg, r):
    """(K6's output, the loop's, the f32 reference) of the held experts on
    one dispatch of routing ``r``, without the shared expert."""
    d = M.dispatch(r, x, cfg)
    xf = x.reshape(-1, x.shape[-1])
    n0 = launches.get("moe_grouped")
    k6 = M.moe_grouped.moe_grouped(xf, p["wg"], p["wu"], p["wd"], d.token,
                                   d.weight, d.counts, d.offsets, d.inverse,
                                   cfg.top_k)
    assert launches.get("moe_grouped") == n0 + 1
    counts = M.held_counts(d)
    loop = M._experts_loop(p, xf, d, counts)
    torch.cuda.synchronize()
    return k6, loop, _reference(p, x, d, counts), counts


def _route(name, cfg, p, x):
    r = M.moe_route(p, x, cfg)
    S, K = x.shape[1], cfg.top_k
    if name == "empty-experts":       # held experts 2 and 3 get no row
        ids = r.expert_ids.clone()
        ids[..., 0] = torch.where(ids[..., 0] < 4, ids[..., 0] % 2,
                                  ids[..., 0])
        ids[..., 1] = torch.where(ids[..., 1] < 4, 4 + ids[..., 0] % 2,
                                  ids[..., 1])
        return _pinned(r, ids)
    if name == "one-expert-takes-all":
        ids = torch.arange(K, device=x.device).expand(1, S, K) * 3
        return _pinned(r, ids.contiguous())
    return r


# (name, d, f, E, K, held, S, route fields)
CASES = [
    ("empty-experts", 256, 128, 8, 2, (0, 4), 600, dict(dropless=True)),
    ("one-expert-takes-all", 256, 256, 8, 2, (0, 2), 700,
     dict(dropless=True)),
    ("ragged-rows", 512, 384, 8, 2, None, 1000, dict(capacity_factor=1.0)),
    ("decode-s1", 2048, 1408, 8, 6, None, 1, dict(dropless=True,
                                                  renormalize=False)),
    ("deepseek-v2-lite", 2048, 1408, 64, 6, (8, 8), 2048,
     dict(dropless=True, renormalize=False)),
    ("mixtral-widths", 4096, 14336, 8, 2, None, 300, {}),
]


@pytest.mark.parametrize("name,d,f,E,K,held,S,route", CASES,
                         ids=[c[0] for c in CASES])
def test_k6_against_the_loop(dev, name, d, f, E, K, held, S, route):
    cfg, p, x = _layer(dev, d, f, E, K, held, S, False, **route)
    k6, loop, ref, counts = _both(p, x, cfg, _route(name, cfg, p, x))
    if name == "empty-experts":
        assert counts[2] == counts[3] == 0 < counts[0]
    if name == "one-expert-takes-all":
        assert counts == [S, 0]
    if name == "ragged-rows":
        bm = M.moe_grouped.BLOCK_ROWS
        assert any(c % bm for c in counts) and max(counts) > bm
    assert sum(counts) > 0 and torch.isfinite(k6.float()).all()
    e_k6, e_loop = _rms(k6, ref), _rms(loop, ref)
    assert e_k6 <= 1.25 * e_loop + 1e-4, (e_k6, e_loop)
    assert _rms(k6, loop) <= 0.01


def test_k6_with_no_held_row_writes_the_shared_expert_alone(dev):
    cfg, p, x = _layer(dev, 256, 128, 8, 2, (0, 2), 64, True,
                       dropless=True)
    r = M.moe_route(p, x, cfg)
    r = _pinned(r, torch.full_like(r.expert_ids, 5))
    d = M.dispatch(r, x, cfg)
    xf = x.reshape(-1, 256)
    shared = M.swiglu(p["shared"], xf)
    out = M.moe_grouped.moe_grouped(xf, p["wg"], p["wu"], p["wd"], d.token,
                                    d.weight, d.counts, d.offsets, d.inverse,
                                    cfg.top_k, shared)
    assert int(d.offsets[-1]) == 0 and torch.equal(out, shared)


def test_a_layer_under_autograd_takes_the_loop(dev):
    """A bf16 layer at K6's widths whose weights require grad (training)
    runs the loop, not K6, and every weight of the layer gets a gradient
    (K6 has no backward)."""
    cfg, p, x = _layer(dev, 256, 128, 8, 2, None, 300, True)
    for t in (p["router"], p["wg"], p["wu"], p["wd"], *p["shared"].values()):
        t.requires_grad_(True)
    n0 = launches.get("moe_grouped")
    out, aux = M.moe_forward(p, x, cfg)
    (out.float().square().mean() + aux).backward()
    assert launches.get("moe_grouped") == n0
    for t in (p["router"], p["wg"], p["wu"], p["wd"], *p["shared"].values()):
        assert t.grad is not None and t.grad.abs().max() > 0


def _deepseek(dev, S=2048):
    """DeepSeek-V2-Lite at its published widths, 3 layers (the dense one
    and 2 MoE), a prompt of S ids on the card."""
    cfg = dataclasses.replace(configs.get("deepseek-v2-lite"), n_layers=3)
    model = build(cfg, device=dev, seed=3)
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=dev)
    step = make_prefill(cfg, device=dev, last_only=True)
    return cfg, lambda: step(model, {"tokens": tokens})


@pytest.mark.parametrize("check", ["no-host-wait", "bit-for-bit"])
def test_the_deepseek_prefill_on_k6(dev, check):
    """A whole ``make_prefill(..., last_only=True)`` call never waits on the
    card (``host_syncs`` reads 0: the first call, which loads the library
    and warms cuBLAS, is not counted), runs K6 once a MoE layer, and two
    calls on one seed give the same logits bit for bit."""
    cfg, call = _deepseek(dev)
    first = call()
    torch.cuda.synchronize()
    n0 = launches.get("moe_grouped")
    if check == "no-host-wait":
        with _build.host_syncs(dev) as syncs:
            call()
        torch.cuda.synchronize()
        assert syncs == [0]
        assert launches.get("moe_grouped") == n0 + cfg.n_groups
    else:
        assert torch.equal(call(), first)
