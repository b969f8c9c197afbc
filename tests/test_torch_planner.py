"""The port's planner and sharding hints (``distributed.planner``,
``distributed.shardctx``, ``launch.mesh``'s spec types) against the JAX
package's, in process and without a process group: the rules read axis
names and sizes only (``launch.mesh.AbstractMesh`` here,
``jax.sharding.AbstractMesh`` there). Specs are compared with ``==``,
entry for entry: no tolerance.

  * ``params_sharding`` for all ten archs at full width (the port's weights
    as fake tensors, the reference's as ``eval_shape`` avals) on the
    (16, 16) and (2, 16, 16) production meshes, with the reference dry
    run's plan (``fsdp_axis=("pod", "data")`` above 100e9 params on the
    multi-pod mesh). The port's tree holds one dict a layer; each of its
    leaves is held to the reference's stacked leaf (``reference_view``),
    whose stack dim is replicated.
  * ``cache_sharding`` for every decode shape's cache with the batch hint
    (the port's from ``steps.cache_specs``' meta tensors, the reference's
    from ``eval_shape``).
  * ``placements``, and each ``shardctx`` helper's spec against the spec
    the reference's helper hands ``with_sharding_constraint``.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro import configs as rcfg
from repro.distributed import planner as rplan
from repro.distributed import shardctx as rctx
from repro.distributed import steps as rsteps
from repro.models import build as jbuild
from repro_torch import configs as pcfg
from repro_torch.distributed import planner, shardctx, steps
from repro_torch._tree import flatten_with_paths
from repro_torch.launch.mesh import AbstractMesh, P
from repro_torch.models import build

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    shape, axes = MESHES[kind]
    return AbstractMesh(shape, axes), jax.sharding.AbstractMesh(shape, axes)


def _plans(cfg, kind):
    """The reference dry run's plan for ``cfg`` on ``kind``."""
    if kind == "multi" and cfg.param_count() > 100e9:
        return (planner.PlanConfig(fsdp_axis=("pod", "data")),
                rplan.PlanConfig(fsdp_axis=("pod", "data")))
    return planner.PlanConfig(), rplan.PlanConfig()


def _key(path) -> str:
    return "/".join(str(getattr(q, "key", getattr(q, "idx",
                                                  getattr(q, "name", q))))
                    for q in path)


def _ref_specs(tree) -> dict:
    return {_key(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(cfg, tree, shardings) -> dict:
    """{reference path: the port leaf's spec with the stack dim's None put
    back} — several port leaves land on one stacked reference leaf, and
    must agree."""
    out = {}
    specs = [s.spec for _, s in flatten_with_paths(shardings)]
    for (_, key, stack), spec in zip(planner.reference_view(cfg, tree),
                                     specs):
        full = ((None,) if stack else ()) + tuple(spec)
        assert out.setdefault(key, full) == full, key
    return out


_FAKE = {}


def _port_params(name):
    if name not in _FAKE:
        with FakeTensorMode():
            _FAKE[name] = build(pcfg.get(name), device="cpu").params()
    return _FAKE[name]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("name", rcfg.ARCH_NAMES)
def test_params_sharding_equals_the_reference(name, kind):
    pmesh, jmesh = _meshes(kind)
    cfg = rcfg.get(name)
    pplan, jplan = _plans(cfg, kind)
    avals = jax.eval_shape(jbuild(cfg).init, jax.random.key(0))
    want = _ref_specs(rplan.params_sharding(avals, jmesh, jplan))
    params = _port_params(name)
    got = _port_specs(pcfg.get(name), params, planner.params_sharding(
        params, pmesh, pplan, cfg=pcfg.get(name)))
    assert got == want


DECODE = [(n, s.name) for n in rcfg.ARCH_NAMES for s in rcfg.SHAPES
          if s.kind == "decode" and rcfg.cell_runnable(rcfg.get(n), s)[0]]


@pytest.mark.parametrize("name,shape", DECODE)
def test_cache_sharding_equals_the_reference(name, shape):
    spec = rcfg.SHAPES_BY_NAME[shape]
    for kind in MESHES:
        pmesh, jmesh = _meshes(kind)
        pplan, jplan = _plans(rcfg.get(name), kind)
        jcache = rsteps.cache_specs(rcfg.get(name), spec)
        want = _ref_specs(rplan.cache_sharding(
            jcache, jmesh, jplan, batch_size=spec.global_batch))
        pc = pcfg.get(name)
        cache = steps.cache_specs(pc, pcfg.SHAPES_BY_NAME[shape])
        got = _port_specs(pc, cache, planner.cache_sharding(
            cache, pmesh, pplan, batch_size=spec.global_batch, cfg=pc))
        assert got == want, kind


def test_generic_tree_rules_and_helpers_equal_the_reference():
    """Without ``cfg`` the rules read the tree's own paths, as the
    reference's do (tests/test_distributed.py's cases)."""
    pmesh, jmesh = _meshes("multi")
    tree = {"moe": {"wg": (8, 64, 128)}, "mlp": {"wd": (128, 64)},
            "embedding": {"emb": (256, 64)}, "x": {"router": (64, 8)},
            "conv": (4, 64), "norm": {"scale": (64,)}}
    ptree = jax.tree.map(lambda s: torch.empty(s, device="meta"), tree,
                         is_leaf=lambda t: isinstance(t, tuple))
    jtree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                         tree, is_leaf=lambda t: isinstance(t, tuple))
    for plan in ((planner.PlanConfig(), rplan.PlanConfig()),
                 (planner.PlanConfig(fsdp_axis=("pod", "data")),
                  rplan.PlanConfig(fsdp_axis=("pod", "data")))):
        got = {"/".join(p): tuple(s.spec) for p, s in flatten_with_paths(
            planner.params_sharding(ptree, pmesh, plan[0]))}
        assert got == _ref_specs(rplan.params_sharding(jtree, jmesh,
                                                       plan[1]))
    assert planner._axis_size(pmesh, ("pod", "data")) == 32
    assert planner._div(64, pmesh, ("pod", "data")) == ("pod", "data")
    assert planner._div(63, pmesh, ("pod", "data")) is None
    for m in (pmesh, jmesh):
        assert tuple((planner if m is pmesh else rplan).activation_spec(
            m, seq_axis="model")) == (("pod", "data"), "model", None)
        assert tuple((planner if m is pmesh else rplan).batch_spec(
            m, extra_dims=2)) == (("pod", "data"), None, None)


def test_placements():
    mesh = AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    assert planner.placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert planner.placements(P(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    assert planner.placements(P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):      # the mesh's axis order only
        planner.placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError):      # one dim an axis
        planner.placements(P("model", "model"), mesh)


HELPERS = [
    ("constrain_heads", "heads_spec", (8, 16, 40, 128), {}),
    ("constrain_heads", "heads_spec", (8, 1, 40, 128), {}),
    ("constrain_seq_q", "seq_q_spec", (8, 64, 40, 128), {}),
    ("constrain_seq_q", "seq_q_spec", (8, 30, 40, 128), {}),
    ("constrain_replicated_kv", "replicated_kv_spec", (8, 64, 8, 128), {}),
    ("constrain_experts", "experts_spec", (16, 32, 8, 64),
     {"expert_axis": 0}),
    ("constrain_experts", "experts_spec", (32, 16, 8, 64),
     {"expert_axis": 1}),
    ("constrain_experts", "experts_spec", (6, 32, 8, 64),
     {"expert_axis": 0}),
    ("constrain_axes", "axes_spec", (8, 64, 1, 32),
     {"tp_dims": (1, 2), "dp_dims": (0,)}),
    ("constrain_moe_tokens", "moe_tokens_spec", (8, 128, 16, 64), {}),
    ("constrain_moe_tokens", "moe_tokens_spec", (8, 100, 16, 64), {}),
]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("ref_fn,port_fn,shape,kw", HELPERS)
def test_shardctx_specs_equal_the_reference(ref_fn, port_fn, shape, kw,
                                            kind, monkeypatch):
    """The spec each reference helper hands ``with_sharding_constraint``
    (None where it returns x untouched), inside and outside the hints."""
    pmesh, jmesh = _meshes(kind)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)

    def ref_spec():
        seen.clear()
        getattr(rctx, ref_fn)(x, **kw)
        return seen[0] if seen else None

    def port_spec():
        args = dict(kw)
        if "expert_axis" in args:
            s = getattr(shardctx, port_fn)(shape, args["expert_axis"])
        else:
            s = getattr(shardctx, port_fn)(shape, **args)
        return None if s is None else tuple(s)

    assert port_spec() is None and ref_spec() is None
    with rctx.sharding_hints(jmesh), shardctx.sharding_hints(pmesh):
        assert port_spec() == ref_spec()
        for S in (4096, 4095, 16):
            assert shardctx.moe_group_split(S) == rctx.moe_group_split(S)
        assert shardctx.tp_size() == rctx.tp_size() == 16
