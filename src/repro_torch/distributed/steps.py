"""Train / serve step builders and the dry run's input specs: the JAX
package's ``src/repro/distributed/steps.py``.

``make_train_step`` returns ``step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss (token-mean cross entropy plus 1e-2 times
the MoE Switch loss) and its gradient through autograd, then one AdamW
update, in place on the model's weights. Attention there runs the
reference's own functions (``models.attention``), never K5, which has no
backward. ``make_prefill`` and ``make_decode_step`` run under
``torch.inference_mode()`` (``torch.no_grad()`` on a mesh), so the
prefill's attention is K5.

Batches follow the reference: ``tokens``/``labels`` (LM), plus ``frames``
(whisper's stub frame embeddings) or ``embeds`` (qwen2-vl's stub patch
embeddings, in place of the tokens); numpy arrays or tensors, moved to the
step's device.

With ``mesh=`` (a ``DeviceMesh``, ``launch.mesh``) the steps run on
DTensors, as the reference's jitted steps run under its shardings: the
batch is placed by the ``batch_shardings`` rule (batch over dp), the
activations are redistributed at every group boundary
(``_make_constrain``, sequence-parallel with ``seq_shard``), the model body
runs under ``shardctx.sharding_hints``, and the logits are vocab-sharded
over tp before the loss, whose cross entropy then takes its logsumexp and
its gold logit as partial sums over the vocab shards (the logits are never
gathered). The model's weights are on the mesh already
(``planner.shard_model``); plain tensors in the model code (masks,
positions, the optimizer's step) count as replicated
(``implicit_replication``). The decode step finds its mesh on the cache
(``make_decode_step``) and keeps the weights where they lie. ``input_specs``
and ``cache_specs`` give meta tensors, the counterpart of the reference's
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import optim, resolve_device
from repro_torch._tree import leaves, tree_map, unflatten
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data import place
from repro_torch.kernels._build import spans
from repro_torch.launch.mesh import NamedSharding, P, axis_names, axis_sizes
from . import shardctx
from .planner import PlanConfig, shard_tensor

Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy, in f32; logits may be a vocab-sharded
    DTensor (``_vocab_parallel_terms``)."""
    logits = logits.to(torch.float32)
    if shardctx.is_dtensor(logits):
        lse, gold = _vocab_parallel_terms(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _vocab_parallel_terms(logits, labels):
    """(logsumexp, gold logit) of DTensor logits (B, S, V) whose vocab dim
    may be sharded: the max, the sum of exps and the gold logit are each a
    reduction over the vocab shards (the reference's psum-safe ops), so the
    logits are never gathered. Each rank picks the label's logit where its
    shard holds that row and 0 elsewhere; the picks sum over the shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                        for p in logits.placements])
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = (m + torch.log(torch.sum(torch.exp(logits - m), dim=-1,
                                   keepdim=True)))[..., 0]
    vocab = [isinstance(p, Shard) and p.dim == 2 for p in logits.placements]
    lab_pl = [Replicate() if v else p
              for v, p in zip(vocab, logits.placements)]
    if not shardctx.is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, lab_pl).to_local().long()
    local = logits.to_local()
    V = logits.shape[2]
    off = 0     # the first vocab row of this rank's shard (torch.chunk's cut)
    for i, v in enumerate(vocab):
        if v:
            off += min(mesh.get_local_rank(i) * -(-V // mesh.size(i)), V)
    idx = lab - off
    hit = (idx >= 0) & (idx < local.shape[2])
    pick = torch.gather(local, -1, idx.clamp(0, local.shape[2] - 1)[..., None])
    gold = torch.where(hit, pick[..., 0], 0.0)
    gold = DTensor.from_local(gold, mesh, [Partial() if v else p for v, p in
                                           zip(vocab, logits.placements)],
                              run_check=False)
    return lse, gold


def _forward(cfg: ArchConfig, model, batch: Batch, constrain=None,
             last: bool = False):
    kw = {} if constrain is None else {"constrain": constrain}
    if last:
        kw["last"] = True
    if cfg.enc_layers:
        return model(batch["tokens"], batch["frames"])
    if cfg.frontend == "vision_stub":
        return model(None, embeds=batch["embeds"], **kw)
    return model(batch["tokens"], **kw)


def loss_and_grads(cfg: ArchConfig, model, batch: Batch, *, constrain=None,
                   logits_sharding: Optional[NamedSharding] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(loss, ce, the gradient of the loss for every leaf of
    ``model.params()`` in order); a leaf the loss does not reach gets
    zeros, as the reference's gradient has. The weights require grad for
    the call only; the model's ``remat`` decides the checkpointing.
    ``constrain`` goes to the model's forward; the logits are put on
    ``logits_sharding`` before the loss."""
    params = leaves(model.params())
    frozen = [not p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        with torch.enable_grad():
            logits, aux = _forward(cfg, model, batch, constrain)
            if logits_sharding is not None:
                logits = shard_tensor(logits, logits_sharding)
            ce = softmax_xent(logits, batch["labels"])
            loss = ce + 1e-2 * aux
            del logits
            grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        for p, f in zip(params, frozen):
            if f:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss.detach(), ce.detach(), grads


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _make_constrain(cfg: ArchConfig, mesh, plan: PlanConfig,
                    seq_shard: bool):
    """Activation-sharding constraint applied at every group boundary — the
    mesh-level cascade-consistency rule. With ``seq_shard`` the sequence
    dim shards over the TP axis between blocks (Megatron-style sequence
    parallelism)."""
    if mesh is None or cfg.enc_layers:
        return None
    names = axis_names(mesh)
    dp = tuple(a for a in plan.dp_axes if a in names)
    tp = plan.tp_axis if plan.tp_axis in names else None
    tpn = axis_sizes(mesh)[tp] if tp else 1

    def constrain(x):
        seq_ok = seq_shard and tp and x.shape[1] % tpn == 0 and x.ndim == 3
        return shard_tensor(x, NamedSharding(
            mesh, P(dp, tp if seq_ok else None, None)))

    return constrain


def _logits_sharding(cfg: ArchConfig, mesh, plan: PlanConfig
                     ) -> Optional[NamedSharding]:
    """Vocab over TP, even where the vocab does not divide (DTensor cuts
    unevenly, as GSPMD pads): a replicated (B, S, V) f32 logits tensor is
    the largest buffer of a train step for odd-vocab archs."""
    if mesh is None:
        return None
    names = axis_names(mesh)
    tp_ok = (plan.tp_axis in names
             and cfg.vocab >= axis_sizes(mesh)[plan.tp_axis])
    return NamedSharding(mesh, P(tuple(a for a in plan.dp_axes if a in names),
                                 None, plan.tp_axis if tp_ok else None))


def _input_spec(shape: Tuple[int, ...], mesh, plan: PlanConfig) -> P:
    """``batch_shardings``' rule for one input of ``shape``."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in plan.dp_axes if a in names)
    tp = plan.tp_axis if plan.tp_axis in names else None
    dpn = 1
    for a in dp:
        dpn *= sizes[a]
    spec = [None] * len(shape)
    # batch dim shards only when divisible (long_500k has batch 1)
    if dpn > 1 and shape[0] % dpn == 0:
        spec[0] = dp
    if len(shape) == 3 and tp and shape[1] % sizes[tp] == 0:
        spec[1] = tp
    return P(*spec)


def _on_mesh(batch: Batch, mesh, plan: PlanConfig) -> Batch:
    return {k: None if v is None else shard_tensor(
        v, NamedSharding(mesh, _input_spec(tuple(v.shape), mesh, plan)))
        for k, v in batch.items()}


def _mesh_context(mesh, plan: PlanConfig, stationary: bool = False):
    """The sharding hints and implicit replication of a step on ``mesh``;
    nothing off a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(shardctx.sharding_hints(
        mesh, tp_axis=plan.tp_axis or "model", dp_axes=plan.dp_axes,
        stationary=stationary))
    stack.enter_context(implicit_replication())
    return stack


def _micro(v: torch.Tensor, accum: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum``: rows i*n/accum .. (i+1)*n/accum; of a
    DTensor, the i-th slice of every rank's own rows (no collective; the
    same rows in all, grouped otherwise where the batch is split over
    ranks)."""
    if not shardctx.is_dtensor(v):
        return v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
    from torch.distributed.tensor import DTensor
    local = v.to_local()
    if local.shape[0] % accum:
        raise ValueError(f"{local.shape[0]} rows a rank do not split into "
                         f"{accum}")
    part = local.reshape(accum, local.shape[0] // accum, *local.shape[1:])[i]
    return DTensor.from_local(part, v.device_mesh, v.placements,
                              run_check=False)


def _plain(t):
    """A DTensor metric as the plain tensor of its value."""
    return t.full_tensor() if shardctx.is_dtensor(t) else t


def make_train_step(cfg: ArchConfig, ocfg: optim.AdamWConfig, *,
                    mesh=None, plan: PlanConfig = PlanConfig(),
                    seq_shard: bool = True, accum: int = 1,
                    device="cuda") -> Callable:
    """(model, opt_state, batch) -> (model, opt_state, metrics), the model's
    weights and the state's moments updated in place.

    The reference's ``remat`` is the model's own here, set where it is
    built (``build(cfg, remat=True)``): the port's step takes a model with
    its weights, where the reference's builds a weightless one.
    ``accum > 1`` splits the batch into ``accum`` microbatches of
    consecutive rows (``_micro``) and averages their gradients (summed in
    f32), loss and ce, as the reference's ``lax.scan`` does. ``metrics``: loss, ce, lr and
    grad_norm (before clipping), 0-d tensors on the device. With ``mesh``
    the model's weights and moments are DTensors on it
    (``planner.shard_model``) and the batch is put on it here.
    """
    dev = resolve_device(device)
    constrain = _make_constrain(cfg, mesh, plan, seq_shard)
    kw = dict(constrain=constrain,
              logits_sharding=_logits_sharding(cfg, mesh, plan))

    def train_step(model, opt_state, batch):
        batch = place(batch, dev)
        if mesh is not None:
            batch = _on_mesh(batch, mesh, plan)
        params = model.params()
        with _mesh_context(mesh, plan):
            if accum == 1:
                loss, ce, grads = loss_and_grads(cfg, model, batch, **kw)
            else:
                n = next(v for v in batch.values() if v is not None).shape[0]
                if n % accum:
                    raise ValueError(f"batch {n} does not split into {accum}")
                gsum = [torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves(params)]
                lsum = csum = 0.0
                for i in range(accum):
                    mb = {k: None if v is None else _micro(v, accum, i)
                          for k, v in batch.items()}
                    l, c, g = loss_and_grads(cfg, model, mb, **kw)
                    for acc, gi in zip(gsum, g):
                        acc.add_(gi)
                    lsum, csum = lsum + l, csum + c
                    del g
                grads = [g / accum for g in gsum]
                loss, ce = lsum / accum, csum / accum
            _, opt2, metrics = optim.update(ocfg, unflatten(params, grads),
                                            opt_state, params)
        metrics.update({"loss": loss, "ce": ce})
        return model, opt2, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def make_prefill(cfg: ArchConfig, *, mesh=None,
                 plan: PlanConfig = PlanConfig(), seq_shard: bool = True,
                 device="cuda", last_only: bool = False) -> Callable:
    """(model, batch) -> logits: the full-sequence forward (inference
    prefill) under ``torch.inference_mode()``, so its attention is K5. With
    ``mesh`` the logits are a DTensor on it (``full_tensor()`` gathers
    them), and the forward runs under ``torch.no_grad()`` instead: a
    DTensor weight sliced in inference mode (whisper's ``dec_pos``) fails
    on its version counter. ``last_only`` (a decoder-only ``Transformer``):
    the logits of the last position alone, (B, 1, V), the final norm and
    the head run on that position only, as a serving prefill samples its
    first token there. A profiler that records sees each call as span
    ``repro_torch.prefill``."""
    dev = resolve_device(device)
    constrain = _make_constrain(cfg, mesh, plan, seq_shard)
    if last_only and cfg.enc_layers:
        raise ValueError("last_only takes a decoder-only model")

    def prefill(model, batch):
        span = spans.begin("repro_torch.prefill")
        batch = place(batch, dev)
        if mesh is not None:
            batch = _on_mesh(batch, mesh, plan)
        grad_off = (torch.inference_mode() if mesh is None
                    else torch.no_grad())
        with grad_off, _mesh_context(mesh, plan):
            logits, _ = _forward(cfg, model, batch, constrain, last_only)
        if span is not None:
            span.end()
        return logits

    return prefill


def make_decode_step(cfg: ArchConfig) -> Callable:
    """(model, token, cache, **kw) -> (logits, cache): one serve_step token
    under ``torch.inference_mode()``; the cache is written in place. ``kw``
    goes to ``model.decode_step`` (a decoder's ``embeds`` in place of the
    token).

    The mesh comes from the cache: where its leaves are DTensors (placed by
    ``planner.cache_sharding``, the weights by ``planner.shard_model``) the
    step runs on their mesh, as the reference's jitted step runs under its
    ``cache_sharding`` with the cache donated: the token is placed by the
    ``batch_shardings`` rule (``PlanConfig()``'s tp and dp axes, all a
    decode reads of a plan), the model body runs under the sharding hints
    with the weights kept where they lie (``stationary``: a decode moves a
    few rows, never a weight), and under ``torch.no_grad()`` (a DTensor
    weight sliced in inference mode fails on its version counter, as in
    ``make_prefill``). Each cache leaf is read and written by its own
    ranks only (``shardctx.seq_decode`` for the sequence-split caches, the
    ``*_on_mesh`` steps for the recurrent states), and a leaf placed any
    other way raises. The logits are a DTensor (``full_tensor()``)."""

    plan = PlanConfig()

    def decode(model, token, cache, **kw):
        mesh = _cache_mesh(cache)
        if mesh is None:
            with torch.inference_mode():
                return model.decode_step(token, cache, **kw)
        ins = {k: v for k, v in dict(kw, token=token).items()
               if v is not None and not shardctx.is_dtensor(v)}
        kw.update(_on_mesh(ins, mesh, plan))
        token = kw.pop("token", token)
        with torch.no_grad(), _mesh_context(mesh, plan, stationary=True):
            return model.decode_step(token, cache, **kw)

    return decode


def _cache_mesh(cache):
    """The mesh of a decode cache whose tensors are all DTensors on one
    mesh; None for a cache of plain tensors. Raises for a mixture."""
    ts = [t for t in leaves(cache) if isinstance(t, torch.Tensor)]
    meshes = {id(t.device_mesh): t.device_mesh for t in ts
              if shardctx.is_dtensor(t)}
    if not meshes:
        return None
    if len(meshes) > 1 or not all(shardctx.is_dtensor(t) for t in ts):
        raise ValueError("a decode cache is either all DTensors on one mesh "
                         "or all plain tensors")
    return next(iter(meshes.values()))


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta tensors for every model input of this (arch x shape) cell.

    For ``[audio]``/``[vlm]`` the frontend is a stub: specs carry
    precomputed frame/patch embeddings of the backbone width.
    """
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        # decode inputs are a single token; the context lives in the cache
        return {"token": _meta((B, 1), i32)}
    batch: Dict[str, Any] = {}
    if cfg.enc_layers:
        batch["tokens"] = _meta((B, S), i32)
        batch["frames"] = _meta((B, min(S, 1500), cfg.d_model), bf16)
    elif cfg.frontend == "vision_stub":
        batch["embeds"] = _meta((B, S, cfg.d_model), bf16)
        batch["tokens"] = _meta((B, S), i32)
    else:
        batch["tokens"] = _meta((B, S), i32)
    if shape.is_train:
        batch["labels"] = _meta((B, S), i32)
    return batch


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> Any:
    """The decode cache of this cell in the port's layout
    (``init_cache``), as meta tensors: no allocation. whisper's holds the
    cross attention's K/V of min(S, 1500) encoder frames."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models import attention as A
    assert shape.kind == "decode"
    B, S = shape.global_batch, shape.seq_len
    if cfg.enc_layers:
        T = min(S, 1500)
        kv = (B, T, cfg.n_kv, cfg.hd)
        return {"dec": [{"xk": _meta(kv, torch.bfloat16),
                         "xv": _meta(kv, torch.bfloat16),
                         "self": A.init_cache(encdec._acfg(cfg, True), B, S,
                                              device="meta")}
                        for _ in range(cfg.n_layers)], "pos": 0}
    return {"layers": [transformer.block_cache_init(kind, cfg, B, S,
                                                    device="meta")
                       for kind in transformer.layer_kinds(cfg)], "pos": 0}


def batch_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh,
                    plan: PlanConfig = PlanConfig()) -> Any:
    """NamedShardings for input_specs output: batch dim over dp axes; for 3-D
    embedding inputs (vlm/audio stubs) the sequence dim additionally shards
    over the TP axis, matching the canonical activation spec."""
    return tree_map(lambda t: NamedSharding(
        mesh, _input_spec(tuple(t.shape), mesh, plan)),
        input_specs(cfg, shape))


__all__ = ["softmax_xent", "loss_and_grads", "make_train_step",
           "make_prefill", "make_decode_step", "input_specs", "cache_specs",
           "batch_shardings"]
