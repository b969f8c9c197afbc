"""Sharding planner — the paper's §5.2 DSE transferred to the device mesh:
the JAX package's ``src/repro/distributed/planner.py``.

The cascade rule (A = A', C = C' = 1 between consecutive layers)
generalizes to: **consecutive layers must agree on the activation
sharding**, so that no resharding collective sits on an inter-layer edge.
The planner enforces it by construction: ONE canonical activation spec
everywhere, and parameter specs chosen so every layer consumes and produces
that spec.

Parameter rules (path-pattern based), the reference's line for line:
  * contraction-input weights (d -> h): P(fsdp_axis, tp_axis)   [column-parallel]
  * contraction-output weights (h -> d): P(tp_axis, fsdp_axis)  [row-parallel]
  * expert stacks (E, d, f):            P(tp_axis, fsdp_axis, None)  [EP]
  * embeddings (V, d):                  P(tp_axis, fsdp_axis)   [vocab-parallel]
  * everything 1-D / norms:             replicated
Every rule checks divisibility and falls back to replication.

The rules read the reference's '/'-joined paths and its stacked shapes (a
leading group dim on every scanned leaf). The port holds one dict a layer,
so ``params_sharding(..., cfg=cfg)`` and ``cache_sharding(..., cfg=cfg)``
view each leaf of the port's layout as the reference's (``reference_view``:
the path and the stack it would sit in), apply the rule to the stacked
shape, and drop the stack dim's entry, which is always ``None``. Without
``cfg`` they take any tree, as the reference's do.

A spec becomes DTensor placements through ``placements``: a tensor dim on
axis ``a`` is ``Shard(dim)`` at ``a``'s mesh dim, a tuple of axes shards the
dim at each of them in the tuple's order (which must be the mesh's), and an
axis no dim uses is ``Replicate()``. ``shard_tensor`` and ``shard_model``
put tensors and a model's weights on the mesh that way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch._tree import flatten_with_paths, unflatten
from repro_torch.launch.mesh import (NamedSharding, P, axis_names,
                                     axis_sizes)


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Which mesh axes play which role."""
    fsdp_axis: Optional[Any] = "data"     #: parameter sharding (ZeRO-3)
    tp_axis: Optional[str] = "model"      #: tensor/expert parallelism
    dp_axes: Tuple[str, ...] = ("pod", "data")   #: batch sharding


def _axis_size(mesh, axis) -> int:
    """Axis size; ``axis`` may be a name or a tuple of names (product)."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= _axis_size(mesh, a)
        return n
    return axis_sizes(mesh).get(axis, 1)


def _div(dim: int, mesh, axis):
    """Use ``axis`` (name or tuple — e.g. ZeRO over ('pod','data')) for this
    dim only if divisible (else replicate)."""
    if isinstance(axis, tuple):
        axis = tuple(a for a in axis if a in axis_names(mesh)) or None
        if axis is not None and len(axis) == 1:
            axis = axis[0]
    n = _axis_size(mesh, axis)
    return axis if (n > 1 and dim % n == 0) else None


# path-pattern -> role table. Patterns match the '/'-joined pytree path.
# Plain "wg"/"wu"/"wd"/"wi"/"wo" cover the raw-array MLP params (swiglu /
# gelu_mlp); "<name>/w" covers dense_init-nested weights.
_COL = ("wq/w", "wk/w", "wv/w", "wg", "wu", "wi", "wi/w", "wx/w", "wy/w",
        "wup/w", "wgate/w", "wq_a/w", "wq_b/w", "wkv_a/w", "wkv_b/w",
        "ffn_up/w", "wz/w", "rz/w", "ri/w", "rf/w", "wf/w", "wa/w")
_ROW = ("wo/w", "wd", "wo", "wdown/w", "ffn_dn/w")


def _spec_for(path: str, shape: Tuple[int, ...], mesh,
              plan: PlanConfig) -> P:
    fs, tp = plan.fsdp_axis, plan.tp_axis
    nd = len(shape)

    # leading stack dims (groups / enc / dec) beyond the rule's arity are
    # replicated
    def pad(spec_tail: Tuple) -> P:
        return P(*([None] * (nd - len(spec_tail)) + list(spec_tail)))

    if "embedding" in path or "emb" in path.split("/")[-1]:
        if nd >= 2:
            return pad((_div(shape[-2], mesh, tp), _div(shape[-1], mesh, fs)))
        return P(None)
    if path.endswith("router"):
        return pad((_div(shape[-2], mesh, fs), None))
    # MoE expert stacks: (E, d, f) / (E, f, d), scoped to "moe/" so that a
    # scan-stacked dense swiglu (G, d, f) takes the column/row rules
    if (nd >= 3 and "moe/" in path and "shared" not in path
            and any(path.endswith(s) for s in ("wg", "wu", "wd"))):
        e_ax = _div(shape[-3], mesh, tp)
        # E < tp (mixtral: 8 experts, 16-way model axis): shard the free
        # (d_ff) dim over tp instead, else the stack replicates
        f_ax = None if e_ax is not None else _div(shape[-1], mesh, tp)
        return pad((e_ax, _div(shape[-2], mesh, fs), f_ax))
    if any(path.endswith(s) for s in _COL) and nd >= 2:
        return pad((_div(shape[-2], mesh, fs), _div(shape[-1], mesh, tp)))
    if any(path.endswith(s) for s in _ROW) and nd >= 2:
        return pad((_div(shape[-2], mesh, tp), _div(shape[-1], mesh, fs)))
    if path.endswith("conv") and nd >= 2:          # depthwise conv kernels
        return pad((None, _div(shape[-1], mesh, tp)))
    # biases, norms, gates, lambdas: replicate
    return P(*([None] * nd))


# ---------------------------------------------------------------------------
# the port's layout seen as the reference's
# ---------------------------------------------------------------------------

def reference_view(cfg, tree) -> List[Tuple[Tuple[str, ...], str, int]]:
    """For each leaf of a tree in the port's layout (params, a moment, or a
    cache; ``_tree`` order): (its path, the reference's '/'-joined path,
    the size of the stack the reference holds it in, or 0). A layer of a
    ``Transformer`` in the scanned groups is ``groups/b{i}/...`` stacked
    over ``n_groups``, a tail layer ``tail/{j}/...``; an ``EncDec`` layer
    is ``enc/...`` or ``dec/...`` stacked over its layers."""
    n = len(cfg.pattern)
    n_body = cfg.n_groups * n
    out = []
    for path, _ in flatten_with_paths(tree):
        head, rest = path[0], path[2:]
        if head == "layers":
            i = int(path[1])
            if i < n_body:
                ref, stack = ("groups", f"b{i % n}") + rest, cfg.n_groups
            else:
                ref, stack = ("tail", str(i - n_body)) + rest, 0
        elif head == "enc" and cfg.enc_layers:
            ref, stack = ("enc",) + rest, cfg.enc_layers
        elif head == "dec" and cfg.enc_layers:
            ref, stack = ("dec",) + rest, cfg.n_layers
        else:
            ref, stack = path, 0
        out.append((path, "/".join(ref), stack))
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _map_leaves(tree, mesh, cfg, fn):
    """A tree of ``tree``'s structure holding ``NamedSharding(mesh,
    fn(reference path, stacked shape))`` for each leaf: with ``cfg``
    through ``reference_view`` (the stack dim's entry dropped), without it
    on the tree's own paths."""
    flat = flatten_with_paths(tree)
    if cfg is None:
        view = [(p, "/".join(p), 0) for p, _ in flat]
    else:
        view = reference_view(cfg, tree)
    specs = []
    for (_, leaf), (_, key, stack) in zip(flat, view):
        shape = _shape(leaf)
        spec = fn(key, ((stack,) if stack else ()) + shape)
        if stack:
            if spec[0] is not None:
                raise AssertionError(f"{key}: stack dim sharded {spec}")
            spec = P(*spec[1:])
        specs.append(NamedSharding(mesh, spec))
    return unflatten(tree, specs)


def params_sharding(params: Any, mesh, plan: PlanConfig = PlanConfig(),
                    *, cfg=None) -> Any:
    """Tree of NamedShardings matching ``params`` (tensors, meta or fake
    tensors: only shapes are read). With ``cfg`` the tree is in the port's
    layout (``model.params()``) and the rules see the reference's."""
    return _map_leaves(params, mesh, cfg, lambda key, shape: _spec_for(
        key, shape, mesh, plan))


def activation_spec(mesh, plan: PlanConfig = PlanConfig(),
                    *, seq_axis: Optional[str] = None) -> P:
    """THE canonical activation sharding (B, S, d): batch over dp axes,
    optional sequence parallelism, features replicated."""
    dp = tuple(a for a in plan.dp_axes if a in axis_names(mesh))
    return P(dp, seq_axis, None)


def batch_spec(mesh, plan: PlanConfig = PlanConfig(),
               *, extra_dims: int = 1) -> P:
    dp = tuple(a for a in plan.dp_axes if a in axis_names(mesh))
    return P(dp, *([None] * extra_dims))


def cache_sharding(cache: Any, mesh, plan: PlanConfig = PlanConfig(),
                   batch_size: Optional[int] = None, *, cfg=None) -> Any:
    """KV caches: batch over dp axes; the largest remaining dim over TP.

    Preferring the *largest* TP-divisible dim picks the sequence dim of KV
    caches (distributed flash-decode) instead of head/feature dims. The
    batch dim is the first of the leading two dims equal to ``batch_size``
    (a scan-stack group count that divides dp must not be taken for it);
    without the hint, the first leading dim divisible by dp. With ``cfg``
    the cache is in the port's layout (``init_cache``) and the rule sees the
    reference's stacked shapes; a non-tensor leaf (a length, a position) is
    a scalar.
    """
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in plan.dp_axes if a in sizes)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]

    def one(_key, shape):
        if not shape:
            return P()
        spec = [None] * len(shape)
        batch_dim = None
        for i, d in enumerate(shape[:2]):
            if batch_size is not None and d != batch_size:
                continue
            if dp_size > 1 and d % dp_size == 0:
                spec[i] = dp
                batch_dim = i
                break
        tp = plan.tp_axis
        tpn = _axis_size(mesh, tp)
        if tp and tpn > 1 and len(shape) >= 3:
            first = (batch_dim + 1) if batch_dim is not None else 1
            cands = [(shape[j], j) for j in range(first, len(shape))
                     if spec[j] is None and shape[j] % tpn == 0
                     and shape[j] >= tpn]
            if cands:
                _, j = max(cands)
                spec[j] = tp
        return P(*spec)

    return _map_leaves(cache, mesh, cfg, one)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = []
    for a in names:
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        if len(dims) > 1:
            raise ValueError(f"axis {a!r} shards dims {dims} of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        if isinstance(e, tuple):
            order = [names.index(a) for a in e if a in names]
            if order != sorted(order):
                raise ValueError(f"{e}: DTensor splits a dim in the mesh's "
                                 f"axis order {names}")
    return out


def shard_tensor(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a DTensor with ``sharding``. A plain tensor is cut locally
    (every rank holds the same values: no collective); on a one-rank mesh
    it is wrapped as it is, without a copy. A DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = sharding.mesh
    pl = placements(sharding.spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def shard_model(model, mesh, plan: PlanConfig = PlanConfig()):
    """Puts every weight of ``model`` (a ``Transformer`` or ``EncDec``) on
    ``mesh`` by ``params_sharding``, in place; returns the model."""
    specs = dict(flatten_with_paths(params_sharding(model.params(), mesh,
                                                    plan, cfg=model.cfg)))
    for name, prm in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = torch.nn.Parameter(
            shard_tensor(prm.data, specs[tuple(name.split("."))]),
            requires_grad=prm.requires_grad)
    return model


__all__ = ["PlanConfig", "params_sharding", "activation_spec", "batch_spec",
           "cache_sharding", "reference_view", "placements", "shard_tensor",
           "shard_model"]
