"""Expert parallelism of the port's MoE layer (``models.moe._moe_ep``,
``distributed.shardctx.expert_parallel``) on a 4-rank gloo mesh of CPU
processes, against the port's own unsharded layer (``moe._moe_groups``,
itself held to the JAX package's in tests/test_torch_moe.py) on the same
dispatch groups, in f32.

On the (2, 2) ``("data", "model")`` mesh tp = 2 divides E = 4, so every
case runs expert-parallel, each rank holding 2 experts (the planner's
P(model, data, None) stacks):
  * the exchange: a prefill whose S (16) divides over tp, each rank routing
    its (G/dp, S/tp) rows; the reference's (G·tp, S/tp) groups;
  * the pick: S = 15, the rows whole over tp; the reference's (G, S)
    groups;
  * the decode step's pick (``sharding_hints(stationary=True)``, S = 1):
    the stacks stay where they lie, x's rows move; groups (B, 1).
Top-1 with the shared expert and top-2, with capacity factor 0.5, so that
capacity drops choices (each prefill case checks that it does; a decode
group is one token, which capacity never drops). On a (4, 1) mesh
(tp = 1, the stacks split on d over 4 data ranks) the exchange is a
one-rank all-to-all and the decode step's pick multiplies on d columns.

Bounds: outputs and the aux loss within F32_TOL = 2e-5 (rtol = atol; the
bound of tests/test_torch_moe.py's f32 cases: the same sums in another
order); in the train layouts, every gradient (x, router, stacks, shared
expert) within GRAD_TOL = 2e-5 of the largest element of its reference.

Every rank records each functional collective it runs (op, group, operand
shape) through the train step (forward and backward) and the decode step:
no collective over the model (tp) group carries an expert weight block (a
shape ending in (d or d/dp, f) or (f or f/dp, d)), in train the stacks are
all-gathered over data (the records see weight blocks where they move) and
all-to-all'd tokens cross tp, and in decode no collective carries an
expert weight block at all.
"""
import numpy as np
import pytest
import torch

import _torch_ranks

F32_TOL = GRAD_TOL = 2e-5
D, FF, E = 32, 48, 4
B = 4
# name -> (top_k, shared expert, S, mesh shape, stationary)
CASES = {
    "exchange-top1-shared": (1, True, 16, (2, 2), False),
    "exchange-top2": (2, False, 16, (2, 2), False),
    "pick-top1-shared": (1, True, 15, (2, 2), False),
    "pick-top2": (2, False, 15, (2, 2), False),
    "decode-top1-shared": (1, True, 1, (2, 2), True),
    "decode-top2": (2, False, 1, (2, 2), True),
    "tp1-exchange-top1-shared": (1, True, 16, (4, 1), False),
    "tp1-decode-top2": (2, False, 1, (4, 1), True),
}
TRAIN = [n for n, c in CASES.items() if not c[4]]
MODES = {"exchange": "exchange", "pick": "pick", "decode": "stationary",
         "tp1-exchange": "exchange", "tp1-decode": "stationary"}


def _mode(name: str) -> str:
    return next(MODES[k] for k in sorted(MODES, key=len, reverse=True)
                if name.startswith(k + "-"))


def _inputs(name):
    """The case's f32 weights ({"moe": ...}, the reference's layout and
    scale) and x (B, S, D), from a numpy seed of the case."""
    _, shared, S, _, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    p = {"router": rng.normal(0, D ** -0.5, (D, E)),
         "wg": rng.normal(0, D ** -0.5, (E, D, FF)),
         "wu": rng.normal(0, D ** -0.5, (E, D, FF)),
         "wd": rng.normal(0, FF ** -0.5, (E, FF, D))}
    if shared:
        p["shared"] = {"wg": rng.normal(0, D ** -0.5, (D, FF)),
                       "wu": rng.normal(0, D ** -0.5, (D, FF)),
                       "wd": rng.normal(0, FF ** -0.5, (FF, D))}
    x = rng.normal(0, 1, (B, S, D))
    probe = rng.normal(0, 1, (B, S, D))
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    tree = {"moe": {k: ({kk: f(vv) for kk, vv in v.items()}
                        if isinstance(v, dict) else f(v))
                    for k, v in p.items()}}
    return tree, f(x), f(probe)


def _cfg(name):
    from repro_torch.models import moe
    K, shared, *_ = CASES[name]
    return moe.MoEConfig(d_model=D, d_ff=FF, n_experts=E, top_k=K,
                         capacity_factor=0.5, shared_expert=shared)


def _reference(name, train: bool):
    """The unsharded layer on the groups the mesh run routes (``split`` =
    tp where S divides over it, the reference's ``moe_group_split``):
    (out, aux, dropped choices, grads by name or None)."""
    from repro_torch._tree import flatten_with_paths
    from repro_torch.models import moe
    tree, x, probe = _inputs(name)
    cfg = _cfg(name)
    _, _, S, (_, tp), _ = CASES[name]
    split = tp if tp > 1 and S % tp == 0 else 1
    p = tree["moe"]
    leaves = [t for _, t in flatten_with_paths(tree)]
    if train:
        x.requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
    with torch.enable_grad() if train else torch.no_grad():
        log = []
        with moe.routing_log(log):
            out, routed, prob = moe._moe_groups(
                p, x.reshape(B * split, S // split, D), cfg)
        out = out.reshape(B, S, D)
        n = B * S
        aux = E * torch.sum((routed / n) * (prob / n))
        grads = None
        if train:
            ((out * probe).sum() + aux).backward()
            grads = {"x": x.grad.numpy()}
            for path, t in flatten_with_paths(tree):
                grads["/".join(path)] = t.grad.numpy()
    return (out.detach().numpy(), float(aux.detach()),
            sum(r.dropped for r in log),
            grads)


class _Collectives(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (op, group name, operand shapes) of every c10d functional
    collective run under it (DTensor ops come back as their local ops)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        from repro_torch.launch.hlo_analysis import _C10D
        if (func.namespace == "_c10d_functional"
                and func.overloadpacket.__name__ in _C10D):
            group = next(a for a in (*reversed(args),
                                     *(kwargs or {}).values())
                         if isinstance(a, str) and a not in ("sum", "avg",
                                                             "max", "min"))
            ts = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            self.seen.append((func.overloadpacket.__name__, group,
                              [tuple(t.shape) for t in ts]))
        return func(*args, **(kwargs or {}))


def _run(name, mesh, train: bool):
    """The case on the mesh: (out, aux, the layouts its routing recorded,
    grads or None, the collectives recorded)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch._tree import flatten_with_paths, unflatten
    from repro_torch.distributed import steps
    from repro_torch.distributed.planner import (PlanConfig, params_sharding,
                                                 placements, shard_tensor)
    from repro_torch.launch.mesh import P
    from repro_torch.models import moe
    tree, x, probe = _inputs(name)
    cfg = _cfg(name)
    _, _, S, (_, tp), stay = CASES[name]
    specs = flatten_with_paths(params_sharding(tree, mesh))
    tree = unflatten(tree, [shard_tensor(t, s) for (_, t), (_, s) in
                            zip(flatten_with_paths(tree), specs)])
    seq = "model" if tp > 1 and S % tp == 0 else None
    xd = distribute_tensor(x, mesh, placements(P("data", seq, None), mesh))
    leaves = [t for _, t in flatten_with_paths(tree)]
    if train:
        xd = xd.detach().requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
    rec, log = _Collectives(), []
    with torch.enable_grad() if train else torch.no_grad(), rec, \
            moe.routing_log(log), \
            steps._mesh_context(mesh, PlanConfig(), stationary=stay):
        out, aux = moe.moe_forward(tree["moe"], xd, cfg)
        grads = None
        if train:
            pd = distribute_tensor(probe, mesh, out.placements)
            ((out * pd).sum() + aux).full_tensor().backward()
    if train:
        grads = {"x": xd.grad.full_tensor().numpy()}
        for path, t in flatten_with_paths(tree):
            grads["/".join(path)] = t.grad.full_tensor().numpy()
    out = out.full_tensor().detach().numpy()
    aux = float(aux.full_tensor())
    return out, aux, [r.layout for r in log], grads, rec.seen


def _port(rank, world):
    from repro_torch.launch.mesh import make_mesh
    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
              for shape in {c[3] for c in CASES.values()}}
    res = {}
    for name, (_, _, _, shape, _) in CASES.items():
        mesh = meshes[shape]
        groups = {mesh.get_group(a).group_name: a for a in ("data", "model")}
        out, aux, layouts, _, seen = _run(name, mesh, train=False)
        res[name] = {"out": out, "aux": aux, "layouts": layouts,
                     "seen": [(op, groups.get(g, g), s) for op, g, s in seen]}
        if name in TRAIN:
            _, _, _, grads, seen = _run(name, mesh, train=True)
            res[name].update(grads=grads, seen_train=[
                (op, groups.get(g, g), s) for op, g, s in seen])
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _torch_ranks.run(_port, 4, tmp_path_factory.mktemp("moe_ep"))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_layer_matches_the_unsharded_layer(results, name):
    ranks = results
    want, aux, dropped, _ = _reference(name, train=False)
    # a decode group is one token, whose choices (distinct experts) all
    # take slot 0: capacity never binds there
    assert dropped > 0 or CASES[name][2] == 1, "capacity must drop choices"
    for r in ranks:
        got = r[name]
        assert got["layouts"] == ["expert-parallel " + _mode(name)]
        assert got["out"].shape == want.shape
        np.testing.assert_allclose(got["out"], want, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(got["aux"], aux, rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("name", TRAIN)
def test_expert_parallel_gradients_match_the_unsharded_layer(results, name):
    """x's, the router's, the stacks' and the shared expert's gradients of
    sum(out * probe) + aux: a lost or misrouted gradient of an all-to-all,
    or a partial sum counted twice, moves some leaf by order 1."""
    _, _, _, want = _reference(name, train=True)
    got = results[0][name]["grads"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= GRAD_TOL, (k, _rel(got[k], want[k]))


def _weight_blocks(dp: int) -> set:
    """The trailing shapes of an expert weight block: a stack's (d, f) and
    (f, d), whole or split on its first dim over dp."""
    return {(D, FF), (D // dp, FF), (FF, D), (FF // dp, D)}


def _carries_a_block(shape, blocks) -> bool:
    return len(shape) >= 2 and tuple(shape[-2:]) in blocks


@pytest.mark.parametrize("step", ["train", "decode"])
def test_no_expert_weight_crosses_the_tp_group(results, step):
    names = [n for n, c in CASES.items() if c[3] == (2, 2)
             and c[4] == (step == "decode")]
    blocks = _weight_blocks(2)
    for r in results:
        for name in names:
            seen = r[name]["seen_train" if step == "train" else "seen"]
            assert seen, name
            over_tp = [(op, s) for op, g, s in seen if g == "model"]
            bad = [(op, s) for op, s in over_tp
                   if any(_carries_a_block(x, blocks) for x in s)]
            assert not bad, (name, bad)
            if step == "train":
                # the records see the stacks where they do move: ZeRO-3's
                # gather over data; the tokens cross tp
                assert any(op.startswith("all_gather") and g == "data"
                           and any(x[-2:] in ((D // 2, FF), (FF // 2, D))
                                   for x in s) for op, g, s in seen), name
                if name.startswith("exchange"):
                    assert any(op == "all_to_all_single"
                               for op, _ in over_tp), name
            else:
                moved = [(op, g, s) for op, g, s in seen
                         if any(_carries_a_block(x, blocks) for x in s)]
                assert not moved, (name, moved)
