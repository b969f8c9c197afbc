"""Mixture-of-Experts layer (token-choice top-1 / top-2): the JAX package's
``src/repro/models/moe.py``.

Used by llama4-maverick (128 experts, top-1, shared expert) and mixtral-8x7b
(8 experts, top-2). The routing is the reference's to the bit: the router in
f32 on ``x.float()``, softmax, top-k (descending, as ``lax.top_k``), the
selected gates renormalized, and capacity C per expert and dispatch group
in GShard's choice-major priority (the k-th choices of all tokens queue
after the (k-1)-th, each in token order); a choice past capacity is dropped
and contributes nothing.

The reference dispatches and combines with (G, S, K, E, C) one-hot einsums
(1.3 GB in f32 at mixtral's S = 8192, and some 2.7 TFLOP a layer). The same
sums are taken here in index form: the kept (token, choice) pairs are
grouped by expert, each expert's SwiGLU runs on the rows routed to it (the
stacked (E, d, f) weights, ``torch.matmul``, as the reference leaves its
expert einsums to XLA), and the gate-weighted outputs are added back into
their tokens with ``index_add_``. An expert that received no token is
skipped (decode), which changes no sum: its one-hot rows are zero in the
reference. On a mesh the dispatch groups follow the reference's sequence
split (``moe_forward``); the reference's pins of its dispatched tensors
(``xin``/``eout``, ``moe.py:102-111``) have no counterpart, because the
index form builds neither: each rank's groups stay on the rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import shardctx
from .blocks import Params, _init, swiglu, swiglu_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False      #: llama4-style always-on expert


def _stacked(gen, shape, dtype, device) -> torch.Tensor:
    """An (E, a, b) weight at the reference's ``_init`` scale, 1/sqrt(E)
    (its first axis), drawn f32 one expert at a time into ``dtype``: the f32
    transient is one expert's, not the stack's (llama4's whole (128, 5120,
    8192) stack in f32 would be 21.5 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / shape[0] ** 0.5
    for e in range(shape[0]):
        out[e] = _init(gen, shape[1:], scale=scale, dtype=dtype,
                       device=device)
    return out


def moe_init(gen, cfg: MoEConfig, dtype=torch.float32, device=None) -> Params:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        # the router stays f32, as the reference's: a bf16 router would
        # change which experts top-k picks
        "router": _init(gen, (d, E), dtype=torch.float32, device=device),
        "wg": _stacked(gen, (E, d, f), dtype, device),
        "wu": _stacked(gen, (E, d, f), dtype, device),
        "wd": _stacked(gen, (E, f, d), dtype, device),
    }
    if cfg.shared_expert:
        p["shared"] = swiglu_init(gen, d, f, dtype=dtype, device=device)
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts) + 1
    return max(c, 1)


class Routing(NamedTuple):
    """Where each (group, token, choice) goes; (G, S, K) but ``probs``."""
    probs: torch.Tensor       # (G, S, E) f32 router softmax
    gates: torch.Tensor       # (G, S, K) f32, renormalized
    expert_ids: torch.Tensor  # (G, S, K) int64
    slot: torch.Tensor        # (G, S, K) int64, place in the expert's queue
    keep: torch.Tensor        # (G, S, K) bool, slot < capacity
    capacity: int

    @property
    def dropped(self) -> int:
        """Choices dropped by capacity."""
        return int((~self.keep).sum())


def moe_route(p: Params, x: torch.Tensor, cfg: MoEConfig) -> Routing:
    """The reference's routing (``moe.py:70-89``) for x (G, S, d)."""
    G, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = x.float() @ p["router"].float()                  # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = torch.topk(probs, K, dim=-1)          # (G,S,K)
    # renormalize the selected gates (mixtral convention)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # choice-major: the k-th choices of all tokens queue after the
    # (k-1)-th; a choice's slot is the number of earlier entries of the
    # same expert in that order (the count runs along the last, contiguous
    # axis: a scan along an outer axis of 16k entries took 3 ms on an H100)
    ids_cm = expert_ids.transpose(1, 2).reshape(G, K * S)
    onehot = F.one_hot(ids_cm, E).transpose(1, 2).contiguous()  # (G,E,KS)
    before = (onehot.cumsum(dim=2) - onehot).gather(1, ids_cm[:, None])
    slot = before[:, 0].reshape(G, K, S).transpose(1, 2)
    C = _capacity(S, cfg)
    return Routing(probs, gates, expert_ids, slot, slot < C, C)


# Set by ``routing_log`` while it is entered: called with each call's
# routing, it returns the routing the layer uses.
_observer: Optional[Callable[[Routing], Routing]] = None


def pinned(r: Routing, expert_ids: torch.Tensor,
           keep: torch.Tensor) -> Routing:
    """``r`` with the experts and kept choices another run of the same
    tokens chose: the gates are read from ``r``'s own probabilities at those
    experts and renormalized, so only the choice is carried over."""
    gates = r.probs.gather(-1, expert_ids)
    return r._replace(gates=gates / gates.sum(dim=-1, keepdim=True),
                      expert_ids=expert_ids, keep=keep)


@contextlib.contextmanager
def routing_log(log: List[Routing],
                pick: Optional[Callable[[int], Tuple[torch.Tensor,
                                                     torch.Tensor]]] = None):
    """While entered, every MoE layer's routing is appended to ``log`` in
    call order: which expert each token chose, what capacity dropped, the
    router's probabilities. With ``pick``, a function of the call's index
    giving ``(expert_ids, keep)``, each call routes those instead
    (``pinned``), and ``log`` holds the routing the layer computed itself.
    Two runs that round apart (a decode step and the prefill) can then be
    held together at every position, where a router near-tie would
    otherwise send one token elsewhere."""
    global _observer

    def observe(r: Routing) -> Routing:
        log.append(r)
        return r if pick is None else pinned(r, *pick(len(log) - 1))

    saved, _observer = _observer, observe
    try:
        yield log
    finally:
        _observer = saved


def moe_forward(p: Params, x: torch.Tensor, cfg: MoEConfig,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (G, S, d) -> (out (G, S, d), aux load-balance loss scalar f32).

    Under sequence parallelism every seq shard is its own dispatch group,
    as in the reference (``shardctx.moe_group_split``): (G, S, d) is read
    as (G*tp, S/tp, d), which changes each group's capacity. On DTensors
    each rank routes and computes its own groups (``shardctx.batch_local``,
    the reference's E < tp layout for every E: token-parallel experts, the
    expert weights all-gathered); the aux loss's two means are partial sums
    over the ranks. In the decode step (``sharding_hints(stationary=True)``)
    the weights stay put instead (``_moe_stationary``).
    """
    G, S, d = x.shape
    E = cfg.n_experts
    split = shardctx.moe_group_split(S)
    if shardctx.is_dtensor(x) and shardctx.weights_stay(x.device_mesh):
        out, routed, prob = _moe_stationary(p, x, cfg)
    elif shardctx.is_dtensor(x):
        out, (routed, prob), pl = shardctx.batch_local(
            lambda xl, lp: _moe_groups(lp, xl, cfg), x, p,
            seq_axis_dim=1 if split > 1 else None)
        routed, prob = (shardctx.partial_sum(t, x, pl)
                        for t in (routed, prob))
    else:
        out, routed, prob = _moe_groups(
            p, x.reshape(G * split, S // split, d), cfg)
        out = out.reshape(G, S, d)
    # load-balance aux loss (Switch/GShard): E * sum_e f_e * P_e, with f_e
    # the fraction of choices routed to e before capacity
    n = G * S
    aux = E * torch.sum((routed / n) * (prob / n))
    return out, aux


def dispatch(r: Routing, x: torch.Tensor, cfg: MoEConfig
             ) -> Tuple[List[int], torch.Tensor, torch.Tensor]:
    """The (token, choice) pairs of ``r`` grouped by expert, for x
    (G, S, d): (the number of kept pairs of each expert, the pairs' tokens
    in expert order, their combine weights: f32 of the gates rounded to
    x's dtype). A dropped pair takes the key E and sorts last, past every
    expert's rows."""
    G, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    key = torch.where(r.keep, r.expert_ids, E).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=E + 1)[:E].tolist()
    token = torch.arange(G * S, device=x.device).repeat_interleave(K)[order]
    weight = r.gates.reshape(-1)[order].to(x.dtype).float()
    return counts, token, weight


def _moe_stationary(p: Params, x, cfg: MoEConfig):
    """The layer on a mesh with its weights where the planner put them (the
    decode step: B tokens of one position). Gathering a whole expert stack
    for B/dp tokens (2.8 GB a layer for mixtral, 32 GB for llama4) would
    dwarf the step's cache, so the tokens move instead: every rank takes
    all G*S tokens (their all-gather, G*S x d) and the router whole
    (d x E), and ``_moe_groups`` routes them all alike, so every rank skips
    the same experts, and multiplies them against the expert weights as
    they lie (``shardctx.expert``, ``shardctx.matmul``). The output is put
    back on x's rows, and the shared expert runs there. Returns (out
    (G, S, d) on x's rows, routed (E,), prob (E,))."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    lp = {"router": p["router"].redistribute(mesh, rep).to_local(),
          **{k: p[k] for k in ("wg", "wu", "wd")}}
    out, routed, prob = _moe_groups(
        lp, x.redistribute(mesh, rep).to_local(),
        dataclasses.replace(cfg, shared_expert=False))
    out = shardctx.as_dtensor(out, x, rep).redistribute(
        mesh, shardctx.row_placements(x))
    if cfg.shared_expert:
        out = out + swiglu(p["shared"], x)
    return out, routed, prob


def _moe_groups(p: Params, x: torch.Tensor, cfg: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer on dispatch groups x (G, S, d): (out (G, S, d), the
    choices routed to each expert (E,) f32, the router's probabilities
    summed over the tokens (E,)).

    The combine weights are the gates rounded to x's dtype, as the
    reference's ``combine.astype(x.dtype)``; the weighted expert outputs
    are summed in f32 and rounded to x's dtype once. x is a plain tensor;
    the expert weights may be DTensors where they lie (``_moe_stationary``):
    each expert's tokens then count as replicated on their mesh, and its
    output comes back whole (an all-gather of n x d).
    """
    G, S, d = x.shape
    E = cfg.n_experts
    r = moe_route(p, x, cfg)
    if _observer is not None:
        r = _observer(r)
    xf = x.reshape(G * S, d)
    counts, token, weight = dispatch(r, x, cfg)
    out = torch.zeros((G * S, d), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        tok = token[start:start + n]
        xe = shardctx.as_dtensor(xf[tok], p["wg"])
        h = (F.silu(shardctx.matmul(xe, shardctx.expert(p["wg"], e)
                                    .to(x.dtype)))
             * shardctx.matmul(xe, shardctx.expert(p["wu"], e).to(x.dtype)))
        ye = shardctx.matmul(h, shardctx.expert(p["wd"], e).to(x.dtype))
        if shardctx.is_dtensor(ye):
            ye = ye.full_tensor()
        out.index_add_(0, tok, ye.float() * weight[start:start + n, None])
        start += n
    out = out.to(x.dtype).reshape(G, S, d)
    if cfg.shared_expert:
        out = out + swiglu(p["shared"], x)
    routed = F.one_hot(r.expert_ids, E).sum(dim=(0, 1, 2)).float()
    return out, routed, r.probs.sum(dim=(0, 1))
