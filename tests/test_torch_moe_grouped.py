"""The MoE layer's device-side tables (``models.moe.dispatch``) and the rule
that picks the grouped kernel K6 or the loop, on the CPU.

K6 (``kernels.moe_grouped``) runs only on the card; what it reads is built
here with torch operations that run anywhere: each held expert's first
sorted row (``offsets``), the tile table that K6's wrapper builds from the
counts and offsets (``moe_grouped.tile_table``: each tile's expert and first
sorted row, the tiles in use on the device) and the inverse of the sort. They are held against the loop's own slicing of the
same dispatch (``_experts_loop``: ``counts`` on the host, each expert's
rows ``token[start:start + n]``), with and without capacity drops and with
a held range that does not start at expert 0; and K6's algorithm, written
out over those tables (tiles, then the combine in choice order through the
inverse), gives the loop's output within f32 rounding (the two sum a
token's choices in other orders). The card tests
(``test_torch_moe_grouped_cuda.py``) hold the kernel to the loop.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import moe_grouped as K6
from repro_torch.models import moe as M

BM = K6.BLOCK_ROWS

# (name, MoEConfig fields, groups, tokens a group): several tiles an expert
CASES = [
    ("dropless", dict(n_experts=4, top_k=2, dropless=True), 2, 300),
    ("capacity-drops", dict(n_experts=4, top_k=2, capacity_factor=0.5),
     2, 500),
    ("held-2-of-6", dict(n_experts=6, top_k=3, dropless=True,
                         renormalize=False, held=(2, 3)), 1, 500),
    ("held-1-of-4-drops", dict(n_experts=4, top_k=2, capacity_factor=1.0,
                               held=(1, 2)), 3, 200),
]


def _case(fields, G, S, d=16, f=24, seed=0):
    cfg = M.MoEConfig(d_model=d, d_ff=f, **fields)
    gen = torch.Generator().manual_seed(seed)
    p = M.moe_init(gen, cfg)
    x = torch.randn((G, S, d), generator=gen)
    return cfg, p, x, M.moe_route(p, x, cfg)


def _loop_slices(cfg, r):
    """Each held expert's rows as the loop reads them, built independently
    of ``dispatch``: the tokens of its kept choices in token order."""
    first, n = cfg.held_range
    ids = r.expert_ids.reshape(-1, cfg.top_k)
    keep = r.keep.reshape(-1, cfg.top_k)
    return [[s for s in range(ids.shape[0]) for k in range(cfg.top_k)
             if keep[s, k] and ids[s, k] == first + j] for j in range(n)]


@pytest.mark.parametrize("name,fields,G,S", CASES, ids=[c[0] for c in CASES])
def test_offsets_tiles_and_inverse_match_the_loops_slicing(name, fields, G,
                                                           S):
    cfg, p, x, r = _case(fields, G, S)
    d = M.dispatch(r, x, cfg)
    slices = _loop_slices(cfg, r)
    n, K, rows = len(slices), cfg.top_k, G * S * cfg.top_k
    counts = [len(s) for s in slices]
    if "drops" in name:
        assert r.dropped > 0
    assert d.counts.tolist() == counts == M.held_counts(d)
    assert d.offsets.tolist() == np.concatenate([[0], np.cumsum(counts)]
                                                ).tolist()
    start = 0
    for e, c in enumerate(counts):   # the loop's slicing
        assert d.token[start:start + c].tolist() == slices[e]
        start += c
    # the inverse: a permutation; a held (token, choice)'s row lies in its
    # expert's range and holds its token and gate, an unheld one past them
    assert sorted(d.inverse.tolist()) == list(range(rows))
    first = cfg.held_range[0]
    ids, keep = r.expert_ids.reshape(-1), r.keep.reshape(-1)
    gates = r.gates.reshape(-1).to(x.dtype).float()
    for i in range(rows):
        row, e = int(d.inverse[i]), int(ids[i]) - first
        if keep[i] and 0 <= e < n:
            assert d.offsets[e] <= row < d.offsets[e + 1]
            assert int(d.token[row]) == i // K
            assert d.weight[row] == gates[i]
        else:
            assert row >= d.offsets[n]
    # the tiles: every expert's rows in BM-row tiles, in expert order
    want = [(e, int(d.offsets[e]) + j * BM) for e, c in enumerate(counts)
            for j in range(-(-c // BM))]
    assert max(counts) > BM        # some expert spans tiles
    tiles, n_tiles = K6.tile_table(d.counts, d.offsets, rows)
    assert int(n_tiles) == len(want)
    assert tiles.shape == (K6.ops.max_tiles(rows, n), 2)
    assert [tuple(t) for t in tiles[:len(want)].tolist()] == want


def _k6_over_tables(p, x, d, K):
    """K6's algorithm over the tables, in f32: each tile's rows through
    its expert (gate and up rounded as the loop rounds, the down product
    and its weight in f32), then each token's held choices summed in choice
    order through the inverse."""
    xf = x.reshape(-1, x.shape[-1])
    y = torch.zeros((d.token.shape[0], xf.shape[1]))
    tiles, n_tiles = K6.tile_table(d.counts, d.offsets, d.token.shape[0])
    for e, r0 in tiles[:int(n_tiles)].tolist():
        rows = torch.arange(r0, min(r0 + BM, int(d.offsets[e + 1])))
        xe = xf[d.token[rows]]
        h = F.silu(xe @ p["wg"][e]) * (xe @ p["wu"][e])
        y[rows] = (h @ p["wd"][e]) * d.weight[rows, None]
    out = torch.zeros_like(xf)
    held = d.inverse.view(-1, K) < d.offsets[-1]
    for k in range(K):
        out += torch.where(held[:, k, None], y[d.inverse.view(-1, K)[:, k]],
                           0)
    return out.reshape(x.shape)


@pytest.mark.parametrize("name,fields,G,S", CASES, ids=[c[0] for c in CASES])
def test_the_tables_drive_the_loops_sums(name, fields, G, S):
    cfg, p, x, r = _case(fields, G, S, seed=1)
    d = M.dispatch(r, x, cfg)
    xf = x.reshape(-1, x.shape[-1])
    loop = M._experts_loop(p, xf, d, M.held_counts(d)).reshape(x.shape)
    assert loop.abs().max() > 0
    torch.testing.assert_close(_k6_over_tables(p, x, d, cfg.top_k), loop,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("counts", [[0, 0, 0], [0, 300, 0], [BM, 2 * BM, 1],
                                    [1, 0, BM + 1], [0] * 5 + [7]])
def test_the_tile_table_at_its_edges(counts):
    """Empty experts, one expert taking every row, counts on and off a
    multiple of the tile; tiles past the ones in use are never read."""
    c = torch.tensor(counts)
    off = F.pad(c.cumsum(0), (1, 0))
    rows = max(sum(counts), 1)
    tiles, n_tiles = K6.tile_table(c, off, rows)
    want = [(e, int(off[e]) + j * BM) for e, n in enumerate(counts)
            for j in range(-(-n // BM))]
    assert n_tiles.tolist() == [len(want)]
    assert tiles.shape[0] == -(-rows // BM) + len(counts) >= len(want)
    assert [tuple(t) for t in tiles[:len(want)].tolist()] == want


def _stacks(dtype=torch.bfloat16, device="cpu", d=256, f=128, n=2):
    """A layer's router, held stacks and shared expert, left empty."""
    return {"router": torch.empty((d, 8), device=device),
            "shared": {k: torch.empty(s, dtype=dtype, device=device)
                       for k, s in (("wg", (d, f)), ("wu", (d, f)),
                                    ("wd", (f, d)))},
            "wg": torch.empty((n, d, f), dtype=dtype, device=device),
            "wu": torch.empty((n, d, f), dtype=dtype, device=device),
            "wd": torch.empty((n, f, d), dtype=dtype, device=device)}


def _rule_case(name):
    """(p, x) of a case, on fake CUDA tensors (no card needed)."""
    with FakeTensorMode():
        if name == "cpu":
            return _stacks(), torch.empty((1, 8, 256), dtype=torch.bfloat16)
        dev = "cuda"
        x = torch.empty((1, 8, 256), dtype=torch.bfloat16, device=dev)
        if name == "k6":
            return _stacks(device=dev), x
        if name == "f32":
            return _stacks(torch.float32, dev), x.float()
        if name == "f32-stacks":
            return _stacks(torch.float32, dev), x
        if name == "d-off-tiles":
            return (_stacks(device=dev, d=192),
                    torch.empty((1, 8, 192), dtype=torch.bfloat16,
                                device=dev))
        if name == "f-off-tiles":
            return _stacks(device=dev, f=96), x
        p = _stacks(device=dev)
        p["wg"] = torch.empty((2, 128, 256), dtype=torch.bfloat16,
                              device=dev).transpose(1, 2)
        return p, x


# (case, why the loop takes it; None where K6 does)
@pytest.mark.parametrize("name,why", [
    ("k6", None), ("cpu", "not contiguous CUDA tensors"),
    ("f32", "not bf16"), ("f32-stacks", "not bf16"),
    ("d-off-tiles", "widths off K6's tiles"),
    ("f-off-tiles", "widths off K6's tiles"),
    ("strided-stack", "not contiguous CUDA tensors")])
def test_the_rule_that_picks_k6_or_the_loop(name, why):
    p, x = _rule_case(name)
    assert M.takes_k6(p, x) is (why is None)


@pytest.mark.parametrize("leaf", ["x", "router", "wg", "wd", "shared.wu",
                                  "model"])
def test_a_layer_that_needs_a_gradient_takes_the_loop(leaf):
    """K6 has no backward: where grad mode is on and x or any weight of the
    layer requires grad (training), the layer takes the loop; the same
    tensors under ``torch.no_grad()`` take K6. "model": the layer's
    weights as a built model holds them (``transformer._Tree``), turned to
    training as ``distributed.steps`` turns them."""
    from repro_torch.models.transformer import _Tree
    p, x = _rule_case("k6")
    if leaf == "x":
        x.requires_grad_(True)
    elif leaf == "shared.wu":
        p["shared"]["wu"].requires_grad_(True)
    elif leaf == "model":
        p = _Tree(p)
        assert M.takes_k6(p, x)
        p.requires_grad_(True)
    else:
        p[leaf].requires_grad_(True)
    assert not M.takes_k6(p, x)
    with torch.no_grad():
        assert M.takes_k6(p, x)


def _dtensor_rule(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    mesh = init_device_mesh("cpu", (world,))
    with FakeTensorMode():
        p = _stacks(device="cuda")
        x = torch.empty((1, 8, 256), dtype=torch.bfloat16, device="cuda")
        plain = M.takes_k6(p, x)
        for k in ("router", "wg", "wu", "wd"):
            p[k] = DTensor.from_local(p[k], mesh, [Replicate()],
                                      run_check=False)
        return plain, M.takes_k6(p, x)


def test_dtensor_stacks_take_the_loop(tmp_path):
    """The stacks where ``_moe_stationary`` leaves them, DTensors on a
    one-rank mesh: the same stacks as plain tensors would take K6."""
    from tests._torch_ranks import run
    assert run(_dtensor_rule, 1, tmp_path) == [(True, False)]


def test_k6_refuses_cpu_tensors():
    cfg, p, x, r = _case(CASES[0][1], 1, 8, d=256, f=128)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    d = M.dispatch(r, x, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        K6.moe_grouped(x.reshape(8, 256).bfloat16(), p["wg"], p["wu"],
                       p["wd"], d.token, d.weight, d.counts, d.offsets,
                       d.inverse, cfg.top_k)


def test_k6_refuses_inputs_that_need_a_gradient():
    """Called under autograd on a tensor that requires grad, K6 raises
    before anything else (its output would carry no gradient)."""
    cfg, p, x, r = _case(CASES[0][1], 1, 8, d=256, f=128)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    d = M.dispatch(r, x, cfg)
    args = (x.reshape(8, 256).bfloat16(), p["wg"], p["wu"], p["wd"],
            d.token, d.weight, d.counts, d.offsets, d.inverse, cfg.top_k)
    for i in range(4):
        grad = list(args)
        grad[i] = grad[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            K6.moe_grouped(*grad)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        K6.moe_grouped(*grad)


def test_a_cpu_layer_takes_the_loop_and_counts_it():
    """Under a profiler, a CPU layer at K6's widths counts 0 for
    ``repro_torch.moe.grouped``, and its rows only when the counters are
    read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    cfg, p, x, r = _case(dict(n_experts=4, top_k=2, dropless=True), 1, 16,
                         d=256, f=128)
    p, x = ({k: v.bfloat16() for k, v in p.items() if k != "router"}
            | {"router": p["router"]}), x.bfloat16()
    rec, old = _build.HotSpans(), M.spans
    M.spans = rec
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            M.moe_forward(p, x, cfg)
        assert rec._later and "repro_torch.moe.rows" not in rec._counts
    finally:
        M.spans = old
    counts = rec.counts()
    assert counts["repro_torch.moe.grouped"] == (1, 0)
    assert counts["repro_torch.moe.rows"] == (1, 16 * 2)
    assert not rec._later



def test_the_grouped_share_reader(monkeypatch):
    """The benchmark's ``moe_grouped_share``: the counter's sum over its
    count in %, and None where no layer was counted (a program without
    the counter)."""
    from portbench import program_spans, spec
    from repro_torch.kernels import _build
    rec = _build.HotSpans()
    monkeypatch.setattr(program_spans, "recorder", lambda: rec)
    assert spec.reader("moe_grouped_share").read(None) is None
    for v in (1, 1, 1, 0):
        rec.count("repro_torch.moe.grouped", v)
    assert spec.reader("moe_grouped_share").read(None) == 75.0
