"""Mixture-of-Experts layer (token-choice top-1 / top-2): the JAX package's
``src/repro/models/moe.py``.

Used by llama4-maverick (128 experts, top-1, shared expert) and mixtral-8x7b
(8 experts, top-2). The routing is the reference's to the bit: the router in
f32 on ``x.float()``, softmax, top-k (descending, as ``lax.top_k``), the
selected gates renormalized, and capacity C per expert and dispatch group
in GShard's choice-major priority (the k-th choices of all tokens queue
after the (k-1)-th, each in token order); a choice past capacity is dropped
and contributes nothing.

DeepSeek-V2 (``configs.deepseek_v2_lite``) adds, each behind a field of
``MoEConfig`` whose default keeps the behaviour above: gates left as the
softmax gives them (``renormalize=False``), no capacity (``dropless``:
every choice is kept, as the published model infers), a shared expert of
its own width (``shared_ff``), and a layer told which experts it holds
(``held``, the chip's share under expert parallelism): it routes over all
``n_experts``, runs only its held experts' SwiGLUs on the rows routed to
them, and adds the shared expert once. What the absent experts would add
is left out; nothing stands in for them or for their exchange.

The reference dispatches and combines with (G, S, K, E, C) one-hot einsums
(1.3 GB in f32 at mixtral's S = 8192, and some 2.7 TFLOP a layer). The same
sums are taken here in index form: ``dispatch`` sorts the kept (token,
choice) pairs by held expert on the device and builds the tables that size
the experts' work there (each held expert's row count and first sorted
row, the inverse of the sort). Then one of two paths runs the held
experts' SwiGLUs on the rows routed to them:

* the grouped path (``takes_k6``): where x and the expert stacks are plain
  CUDA tensors in bf16, K6's tiles divide d and f, and no gradient has to
  pass through the layer, one call of ``kernels.moe_grouped`` (K6) reads
  those tables on the device (and builds its tile table from them there),
  so the layer never waits for the device: no count comes to the host. It
  serves dropless and capacity routing alike (a dropped choice sorts past
  every held expert, as one routed to an expert not held).
* the loop (``_experts_loop``, K6's plain version): everywhere else (CPU
  tensors, f32, DTensor weights where they lie in ``_moe_stationary``,
  training: K6 writes a fresh tensor that autograd cannot see through),
  the held experts' row counts come to the host in one copy, and each
  expert with rows runs on them (the stacked (E, d, f) weights,
  ``torch.matmul``, as the reference leaves its expert einsums to XLA); its
  gate-weighted outputs are added back into their tokens with
  ``index_add_``. An expert that received no token is skipped (decode),
  which changes no sum: its one-hot rows are zero in the reference.

Both sum a token's expert outputs in f32 in a fixed order and round once,
so a call gives the same bits every time: the loop in expert order (its
``index_add_`` of one expert never meets a token twice), K6 in choice order
through the inverse permutation, with no atomics. The two orders differ only
in the f32 rounding of the sum.

On a mesh the dispatch groups follow the reference's sequence
split (``moe_forward``), and its rule for the layout of its dispatched
tensors (``xin``/``eout``, ``moe.py:102-111``): where tp divides E the
layer is expert-parallel (``_moe_ep``), and builds the reference's static
(E, G, C, d) dispatch buffer of each rank's groups, whose expert blocks go
to their owners and back (an all-to-all each way over tp); else each
rank's groups stay on the rank (token-parallel, the index form above).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import shardctx
from repro_torch.kernels import moe_grouped
from repro_torch.kernels._build import CallSpan, host_syncs, spans
from .attention import needs_grad
from .blocks import Params, _init, swiglu, swiglu_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False      #: llama4-style always-on expert
    renormalize: bool = True         #: the top-k gates divided by their sum
    dropless: bool = False           #: no capacity: every choice is kept
    shared_ff: Optional[int] = None  #: the shared expert's width (d_ff)
    #: (first, count) of the experts this layer holds; None: all of them
    held: Optional[Tuple[int, int]] = None

    @property
    def held_range(self) -> Tuple[int, int]:
        return self.held if self.held is not None else (0, self.n_experts)


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
    """The router over all ``n_experts``, the stacks of the held ones."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n = cfg.held_range[1]
    p = {
        # the router stays f32, as the reference's: a bf16 router would
        # change which experts top-k picks
        "router": _init(gen, (d, E), dtype=torch.float32, device=device),
        "wg": _stacked(gen, (n, d, f), dtype, device),
        "wu": _stacked(gen, (n, d, f), dtype, device),
        "wd": _stacked(gen, (n, f, d), dtype, device),
    }
    if cfg.shared_expert:
        p["shared"] = swiglu_init(gen, d, cfg.shared_ff or f, dtype=dtype,
                                  device=device)
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts) + 1
    return max(c, 1)


class Routing(NamedTuple):
    """Where each (group, token, choice) goes; (G, S, K) but ``probs``."""
    probs: torch.Tensor       # (G, S, E) f32 router softmax
    gates: torch.Tensor       # (G, S, K) f32, renormalized unless not
    expert_ids: torch.Tensor  # (G, S, K) int64
    #: (G, S, K) int64, place in the expert's queue; None where dropless
    slot: Optional[torch.Tensor]
    keep: torch.Tensor        # (G, S, K) bool, slot < capacity
    capacity: int
    #: the layer's layout on the mesh (``moe_forward``): "unsharded",
    #: "token-parallel", or "expert-parallel <mode>" (``shardctx.EP``)
    layout: str = "unsharded"
    renormalized: bool = True  #: the gates divided by their sum

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
    if cfg.renormalize:
        # renormalize the selected gates (mixtral convention)
        gates = gates / gates.sum(dim=-1, keepdim=True)
    if cfg.dropless:
        return Routing(probs, gates, expert_ids, None,
                       torch.ones_like(expert_ids, dtype=torch.bool), S * K,
                       renormalized=cfg.renormalize)
    # choice-major: the k-th choices of all tokens queue after the
    # (k-1)-th; a choice's slot is the number of earlier entries of the
    # same expert in that order (the count runs along the last, contiguous
    # axis: a scan along an outer axis of 16k entries took 3 ms on an H100)
    ids_cm = expert_ids.transpose(1, 2).reshape(G, K * S)
    onehot = F.one_hot(ids_cm, E).transpose(1, 2).contiguous()  # (G,E,KS)
    before = (onehot.cumsum(dim=2) - onehot).gather(1, ids_cm[:, None])
    slot = before[:, 0].reshape(G, K, S).transpose(1, 2)
    C = _capacity(S, cfg)
    return Routing(probs, gates, expert_ids, slot, slot < C, C,
                   renormalized=cfg.renormalize)


# Set by ``routing_log`` while it is entered: called with each call's
# routing, it returns the routing the layer uses.
_observer: Optional[Callable[[Routing], Routing]] = None


def pinned(r: Routing, expert_ids: torch.Tensor,
           keep: torch.Tensor) -> Routing:
    """``r`` with the experts and kept choices another run of the same
    tokens chose: the gates are read from ``r``'s own probabilities at those
    experts (and renormalized where ``r``'s were), so only the choice is
    carried over."""
    gates = r.probs.gather(-1, expert_ids)
    if r.renormalized:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return r._replace(gates=gates, expert_ids=expert_ids, keep=keep)


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
    the layout follows the reference's rule (``moe.py:102-111``): where tp
    divides E the layer runs expert-parallel (``_moe_ep``: each rank
    computes its own E/tp experts, which stay put); else token-parallel,
    each rank routing and computing its own groups with the expert weights
    all-gathered (``shardctx.batch_local``), or, in the decode step
    (``sharding_hints(stationary=True)``), with the weights kept where they
    lie (``_moe_stationary``). The aux loss's two means are partial sums
    over the ranks.
    """
    G, S, d = x.shape
    E = cfg.n_experts
    if shardctx.is_dtensor(x) and (cfg.held is not None or cfg.dropless):
        raise ValueError("a held share of the experts, or dropless "
                         "routing, runs on plain tensors only")
    split = shardctx.moe_group_split(S)
    if shardctx.is_dtensor(x) and E % max(1, shardctx.tp_size()) == 0:
        out, routed, prob = _moe_ep(p, x, cfg)
    elif shardctx.is_dtensor(x) and shardctx.weights_stay(x.device_mesh):
        out, routed, prob = _moe_stationary(p, x, cfg)
    elif shardctx.is_dtensor(x):
        out, (routed, prob), pl = shardctx.batch_local(
            lambda xl, lp: _moe_groups(lp, xl, cfg, "token-parallel"), x, p,
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


def _route(p: Params, x: torch.Tensor, cfg: MoEConfig,
           layout: str) -> Routing:
    """``moe_route`` under ``layout``, seen (and maybe pinned) by
    ``routing_log``."""
    r = moe_route(p, x, cfg)._replace(layout=layout)
    return r if _observer is None else _observer(r)


def _stats(r: Routing, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the choices routed to each expert (E,) f32, the router's
    probabilities summed over the tokens (E,))."""
    return (F.one_hot(r.expert_ids, E).sum(dim=(0, 1, 2)).float(),
            r.probs.sum(dim=(0, 1)))


def _moe_ep(p: Params, x, cfg: MoEConfig):
    """The layer expert-parallel (``E % tp == 0``), the reference's
    ``constrain_experts`` layout: ``shardctx.expert_parallel`` places the
    rows and the weights and states the collectives; here each rank routes
    the rows it holds and runs its own experts on them (``_dispatched`` in
    the exchange and the pick, ``_stationary_pick`` in the decode step).
    The shared expert is a dense SwiGLU on x (``swiglu``: its weights split
    over tp as the column- and row-parallel rules put them)."""

    def local(xl, lp, ep):
        r = _route(lp, xl, cfg, f"expert-parallel {ep.mode}")
        fn = _stationary_pick if ep.mode == "stationary" else _dispatched
        return (fn(lp, xl, r, ep, cfg), *_stats(r, cfg.n_experts))

    out, (routed, prob) = shardctx.expert_parallel(
        local, x, {k: p[k] for k in ("router", "wg", "wu", "wd")})
    if cfg.shared_expert:
        out = out + swiglu(p["shared"], x).redistribute(
            out.device_mesh, out.placements)
    return out, routed, prob


def _swiglu_experts(p: Params, xin: torch.Tensor) -> torch.Tensor:
    """Each local expert's SwiGLU on its rows: xin (E_l, n, d) ->
    (E_l, n, d), the stacks cast to xin's dtype."""
    wg, wu, wd = (p[k].to(xin.dtype) for k in ("wg", "wu", "wd"))
    return torch.bmm(F.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu), wd)


def _dispatched(p: Params, x: torch.Tensor, r: Routing, ep, cfg: MoEConfig
                ) -> torch.Tensor:
    """The reference's static dispatch on the rank's groups x (G, S, d):
    each kept (token, choice) row scattered to (expert, group, slot) of a
    zero (E, G, C, d) buffer (a dropped one to a spare row past it), the
    experts run on every slot, and each token's outputs gathered back and
    added in f32 with the gates rounded to x's dtype, as ``_moe_groups``
    does. "exchange": the buffer goes to the experts' owners and back
    (``shardctx.to_experts``, ``from_experts``), and the sum is rounded to
    x's dtype. "pick": the buffer holds the rank's own experts only, and
    the f32 sum is returned, a partial sum over tp."""
    G, S, d = x.shape
    K, C = cfg.top_k, r.capacity
    e, keep = r.expert_ids, r.keep
    if ep.mode == "pick":
        e = e - ep.first
        keep = keep & (e >= 0) & (e < ep.n_local)
    n_e = cfg.n_experts if ep.mode == "exchange" else ep.n_local
    slots = n_e * G * C
    g = torch.arange(G, device=x.device)[:, None, None]
    idx = torch.where(keep, (e * G + g) * C + r.slot, slots).reshape(-1)
    rows = x.reshape(G * S, 1, d).expand(G * S, K, d).reshape(-1, d)
    buf = x.new_zeros((slots + 1, d)).index_add(0, idx, rows)[:slots]
    buf = buf.view(n_e, G * C, d)
    if ep.mode == "exchange":
        y = shardctx.from_experts(
            _swiglu_experts(p, shardctx.to_experts(buf, ep)), ep)
    else:
        y = _swiglu_experts(p, buf)
    y = torch.cat([y.reshape(slots, d), y.new_zeros((1, d))])
    w = r.gates.to(x.dtype).float().reshape(G * S, K, 1)
    out = (y[idx].float().view(G * S, K, d) * w).sum(dim=1).view(G, S, d)
    return out.to(x.dtype) if ep.mode == "exchange" else out


def _stationary_pick(p: Params, x: torch.Tensor, r: Routing, ep,
                     cfg: MoEConfig) -> torch.Tensor:
    """The decode step's pick, the stacks where they lie: x (R, S, d) holds
    the rows of every rank that shares this rank's experts (a few tokens),
    and each local expert multiplies all of them on the rank's d columns
    (wg, wu) and f rows (wd); a (choice, token) takes the product of the
    expert it routes to (at most one local expert matches it: ``where``
    picks it, exactly). Where the stacks' d is split (``ep.dw``) the
    products are f32 partial sums, summed by ``shardctx.dw_sum`` before the
    SwiGLU; the gate-weighted outputs are returned as an f32 partial sum
    over tp (and ``dw``) of (R, S, d)."""
    R, S, d = x.shape
    n, K = R * S, cfg.top_k
    cdt = torch.float32 if ep.dw else x.dtype
    xs = x.reshape(n, d)[:, ep.d_slice].to(cdt)
    e = r.expert_ids.reshape(n, K) - ep.first
    keep = r.keep.reshape(n, K)
    w = r.gates.reshape(n, K).to(x.dtype).float()
    gu = None
    for j in range(ep.n_local):
        y = torch.stack([xs @ p["wg"][j].to(cdt), xs @ p["wu"][j].to(cdt)],
                        dim=1)                               # (n, 2, f)
        m = (keep & (e == j)).T[..., None, None]             # (K, n, 1, 1)
        gu = torch.where(m, y, 0 if gu is None else gu)
    gu = shardctx.dw_sum(gu, 3, ep).to(x.dtype)
    h = F.silu(gu[:, :, 0]) * gu[:, :, 1]                    # (K, n, f_l)
    out = x.new_zeros((n, d), dtype=torch.float32)
    for j in range(ep.n_local):
        m = keep & (e == j)                                  # (n, K)
        hj = torch.where(m.T[..., None], h, 0).sum(dim=0)
        yj = hj.to(cdt) @ p["wd"][j].to(cdt)
        out += torch.where(m, w, 0).sum(dim=1)[:, None] * yj.float()
    return out.view(R, S, d)


class Dispatch(NamedTuple):
    """``dispatch``'s tables for x (G, S, d) and K choices a token, on x's
    device; n is the experts held. A (token, choice) pair is a row, G*S*K
    of them, sorted by held expert."""
    counts: torch.Tensor   # (n,) int64: the kept rows of each held expert
    #: (n + 1,) int64: each held expert's first sorted row; [n] the held rows
    offsets: torch.Tensor
    token: torch.Tensor    # (G*S*K,) int64: the token of each sorted row
    weight: torch.Tensor   # (G*S*K,) f32: its combine weight
    inverse: torch.Tensor  # (G*S*K,) int64: each (token, choice)'s sorted row


def dispatch(r: Routing, x: torch.Tensor, cfg: MoEConfig) -> Dispatch:
    """The (token, choice) pairs of ``r`` grouped by held expert, for x
    (G, S, d), every table built on x's device: nothing comes to the host,
    so the call never waits for the device (``torch.bincount`` would sync
    twice on a CUDA tensor; the counts are a ``scatter_add_``).

    The routing is taken as it is: a kept pair routed to held expert e gets
    the key e, a dropped one, or one routed to an expert not held, the key
    ``n`` (the experts held), and a stable sort by key puts each expert's
    rows together in token order, the unheld ones last. The combine weights
    are the gates rounded to x's dtype, read as f32. From the counts: the
    experts' exclusive offsets; from the sort, its inverse (each (token,
    choice)'s sorted row), through which K6 combines a token's choices in
    choice order. The loop reads the counts on the host (``held_counts``);
    K6 reads the tables on the device."""
    G, S, _ = x.shape
    K = cfg.top_k
    first, n = cfg.held_range
    e = r.expert_ids - first if first else r.expert_ids
    held = r.keep if cfg.held is None else r.keep & (e >= 0) & (e < n)
    key = torch.where(held, e, n).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(n + 1, dtype=key.dtype, device=key.device)
    counts = counts.scatter_add_(0, key, torch.ones_like(key))[:n]
    offsets = F.pad(counts.cumsum(0), (1, 0))
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    weight = r.gates.reshape(-1)[order].to(x.dtype).float()
    return Dispatch(counts, offsets, order // K, weight, inverse)


def held_counts(d: Dispatch) -> List[int]:
    """The held experts' row counts on the host: the loop's one wait on the
    device a layer (one copy, after every launch of the dispatch)."""
    return d.counts.tolist()


def takes_k6(p: Params, x: torch.Tensor) -> bool:
    """Whether the layer runs its held experts by the grouped path (K6) for
    x and the layer's weights, else by the loop: x and the held experts'
    stacks must be plain (no DTensor) bf16 CUDA tensors, the stacks
    contiguous, K6's tiles must divide d and f (``moe_grouped.fits``), and
    no gradient may have to pass through the layer (``needs_grad`` of x,
    the router, the stacks and the shared expert: K6 writes a fresh tensor
    with no backward). Decided from the inputs alone; no setting chooses
    the path."""
    stacks = (p["wg"], p["wu"], p["wd"])
    ts = (x, *stacks)
    shared = ([p["shared"][k] for k in ("wg", "wu", "wd")]
              if "shared" in p else [])
    return (not any(shardctx.is_dtensor(t) for t in ts)
            and all(t.dtype == torch.bfloat16 and t.is_cuda for t in ts)
            and all(t.is_contiguous() for t in stacks)
            and moe_grouped.fits(x.shape[-1], p["wg"].shape[-1])
            and not needs_grad(x, p["router"], *stacks, *shared))


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
        dataclasses.replace(cfg, shared_expert=False), "token-parallel")
    out = shardctx.as_dtensor(out, x, rep).redistribute(
        mesh, shardctx.row_placements(x))
    if cfg.shared_expert:
        out = out + swiglu(p["shared"], x)
    return out, routed, prob


def _moe_groups(p: Params, x: torch.Tensor, cfg: MoEConfig,
                layout: str = "unsharded"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer on dispatch groups x (G, S, d) (``_moe_held``): (out
    (G, S, d), the choices routed to each expert (E,) f32, the router's
    probabilities summed over the tokens (E,)). A profiler that records
    sees it in phases, ``repro_torch.moe.route`` (the router and the
    dispatch's launches), on the loop ``repro_torch.moe.sync`` (the host's
    wait for the held experts' counts), and ``repro_torch.moe.experts`` (the
    rest), and the layer's counters are kept (``_count``)."""
    span = spans.begin("repro_torch.moe.route")
    if span is None:
        return _moe_held(p, x, cfg, layout)[:3]
    with host_syncs(x.device) as syncs:
        out, routed, prob, counts, grouped = _moe_held(p, x, cfg, layout,
                                                       span)
        span.end()
    _count(counts, syncs[0], grouped)
    return out, routed, prob


def _moe_held(p: Params, x: torch.Tensor, cfg: MoEConfig, layout: str,
              span: Optional[CallSpan] = None):
    """The layer on dispatch groups x (G, S, d): (out (G, S, d), the
    choices routed to each expert (E,) f32, the router's probabilities
    summed over the tokens (E,), the rows each held expert got (n,) on x's
    device, whether K6 ran); ``layout`` is recorded in the routing. Only the
    held experts run (``cfg.held``; all by default), each on the rows routed
    to it: by K6 where ``takes_k6``, else by the loop."""
    G, S, d = x.shape
    r = _route(p, x, cfg, layout)
    dsp = dispatch(r, x, cfg)
    xf = x.reshape(G * S, d)
    grouped = takes_k6(p, x)
    if grouped:
        if span is not None:
            span.phase("repro_torch.moe.experts")
        shared = (swiglu(p["shared"], xf) if cfg.shared_expert else None)
        out = moe_grouped.moe_grouped(
            xf.contiguous(), p["wg"], p["wu"], p["wd"], dsp.token,
            dsp.weight, dsp.counts, dsp.offsets, dsp.inverse, cfg.top_k,
            shared).reshape(G, S, d)
    else:
        if span is not None:
            span.phase("repro_torch.moe.sync")
        counts = held_counts(dsp)
        if span is not None:
            span.phase("repro_torch.moe.experts")
        out = _experts_loop(p, xf, dsp, counts).reshape(G, S, d)
        if cfg.shared_expert:
            out = out + swiglu(p["shared"], x)
    return (out, *_stats(r, cfg.n_experts), dsp.counts, grouped)


def _experts_loop(p: Params, xf: torch.Tensor, dsp: Dispatch,
                  counts: List[int]) -> torch.Tensor:
    """The held experts one at a time on x's rows xf (G*S, d), ``counts``
    the rows of each on the host: (G*S, d) in x's dtype. K6's plain
    version.

    The combine weights are the gates rounded to x's dtype, as the
    reference's ``combine.astype(x.dtype)``; the weighted expert outputs
    are summed in f32 and rounded to x's dtype once. xf is a plain tensor;
    the expert weights may be DTensors where they lie (``_moe_stationary``):
    each expert's tokens then count as replicated on their mesh, and its
    output comes back whole (an all-gather of n x d)."""
    out = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    token, weight = dsp.token, dsp.weight
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        tok = token[start:start + n]
        xe = shardctx.as_dtensor(xf[tok], p["wg"])
        h = (F.silu(shardctx.matmul(xe, shardctx.expert(p["wg"], e)
                                    .to(xf.dtype)))
             * shardctx.matmul(xe, shardctx.expert(p["wu"], e).to(xf.dtype)))
        ye = shardctx.matmul(h, shardctx.expert(p["wd"], e).to(xf.dtype))
        if shardctx.is_dtensor(ye):
            ye = ye.full_tensor()
        out.index_add_(0, tok, ye.float() * weight[start:start + n, None])
        start += n
    return out.to(xf.dtype)


def _count(counts: torch.Tensor, syncs: int, grouped: bool) -> None:
    """A traced layer's counters: the host's waits on the device that the
    layer made (``host_syncs``), whether K6 ran (1) or the loop (0), and,
    read from ``counts`` only when the counters are (``count_later``, so
    the layer waits for nothing), the rows its held experts got and their
    largest over their mean."""
    spans.count("repro_torch.moe.syncs", syncs)
    spans.count("repro_torch.moe.grouped", int(grouped))
    spans.count_later(counts, _fold_rows)


def _fold_rows(rows: List[int]):
    total = sum(rows)
    yield "repro_torch.moe.rows", total
    if total:
        yield ("repro_torch.moe.load_max_over_mean",
               max(rows) * len(rows) / total)
