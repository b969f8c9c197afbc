"""Sharding hints for model internals: the JAX package's
``src/repro/distributed/shardctx.py`` on DTensor.

The planner (``distributed/planner.py``) pins parameter and boundary
activation shardings, but tensors *inside* a block (attention heads, MoE
dispatch) are invisible to it. Step builders enter ``sharding_hints``
around the model body; model code calls ``constrain_*`` helpers, which
redistribute a DTensor argument to the reference's spec while a context is
active and return the argument unchanged otherwise (a plain tensor, or no
context), as the reference's helpers are no-ops outside the context.
``*_spec`` gives each helper's spec for a shape (or None where the
reference leaves the tensor alone).

The port's model code calls ``constrain_heads`` and ``moe_group_split``
(which reads ``tp_size``). ``active``, ``constrain_seq_q``,
``constrain_replicated_kv``, ``constrain_experts``, ``constrain_axes`` and
``constrain_moe_tokens`` are kept as the reference's counterparts, whose
specs ``tests/test_torch_planner.py`` holds to the reference's: the
attention and the MoE that would call them run on local tensors instead
(below), in the same layouts.

The head constraint is the Megatron-TP rule: q/k/v shard over the TP axis on
the head dim. Head counts that don't divide the axis shard unevenly (DTensor
cuts as ``torch.chunk`` does, where GSPMD pads).

Ops that have no DTensor sharding rule, or whose own rule is slow or
moves more than the reference's layout, run on local tensors here, each
named with the collectives it adds (the dry run counts them):
  * ``matmul``: every weight product of the models, Megatron/ZeRO-3 style:
    the all-gather of the weight over dp, the sequence all-gather before a
    column-parallel product, the partial sum after a row-parallel one.
  * ``embed``: the vocab-parallel lookup: the table's all-gather over dp,
    the rows' partial sum over tp.
  * ``heads_local``: K5 (``flash_mha``) takes raw pointers. q is
    redistributed to heads over tp, whatever their count (DTensor's
    uneven split: ceil(H/tp) heads a rank at most), and batch over dp
    (when the batch divides it); k/v split alike where KV is H or tp
    divides both, else stay whole over tp and each rank takes the KV heads
    its query heads read. The kernel runs on the local heads and the
    result is wrapped back. Under sequence-parallel hints that is one
    all-to-all of q (S-sharded to head-sharded) and a slice of k/v a layer
    (an all-gather of k/v where they stay whole), and where tp does not
    divide H one all-to-all of the result back to the sequence.
  * ``seq_local``: the reference's dense attention (``_sdpa``, MLA's
    dense score) in the layout of its sequence-parallel hints, each rank on
    its own query rows against the whole k/v: the all-gather of k/v a
    layer (and the reduce-scatter of their gradient).
  * ``batch_local``: a function of batch rows (the RG-LRU, mLSTM and sLSTM
    blocks, the token-parallel MoE's dispatch groups) runs on each rank's
    rows with the weights all-gathered (their gradient reduce-scattered
    back): one all-gather a weight a call, and the activation's
    redistribution to and from batch-over-dp.

The decode step (``steps.make_decode_step``) runs under
``sharding_hints(stationary=True)``: ``matmul`` and ``embed`` move the
step's few rows to the weights, never a weight to the rows. Its cache
leaves are DTensors placed by ``planner.cache_sharding``, and each is read
and written by the ranks that hold it:
  * ``seq_decode``: the distributed flash-decode over a cache whose
    sequence dim tp splits (K/V, MLA's latents): the slot's owner writes
    it, each rank attends over its own keys, and an all-reduce MAX and
    one all-reduce SUM combine the partial softmaxes over tp.
  * ``cache_local``, ``like_state``, ``tp_slice``, ``tp_sum``,
    ``tp_gather``: the pieces the recurrent states (split on their feature
    dim) and whisper's cross K/V (split on the head dim) are updated and
    read with; a leaf placed by no rule raises.
  * ``expert``: one expert of a stacked MoE weight where it lies (the
    token-parallel MoE, ``E % tp != 0``).

Expert parallelism (``E % tp == 0``, llama4's 128 experts over 16) runs in
``expert_parallel`` in every step: each rank computes its own E/tp experts,
which never move over tp; the tokens move to them (the all-to-all of the
reference's ``constrain_experts`` layout) or are picked where they lie.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import P, axis_names, axis_sizes

#: The active hints: (mesh, tp axis, dp axes, whether the weights stay where
#: the planner put them (``matmul``, ``embed``; the decode step) rather than
#: being gathered over the dp axes).
_STATE: List[Tuple[object, str, Tuple[str, ...], bool]] = []


@contextlib.contextmanager
def sharding_hints(mesh, *, tp_axis: str = "model",
                   dp_axes: Tuple[str, ...] = ("pod", "data"),
                   stationary: bool = False):
    """Activate sharding hints while a step function runs. ``stationary``
    (the decode step) keeps every weight where the planner put it: the
    products and the lookup move activations instead (``matmul``)."""
    if mesh is None or tp_axis not in axis_names(mesh):
        yield
        return
    _STATE.append((mesh, tp_axis,
                   tuple(a for a in dp_axes if a in axis_names(mesh)),
                   stationary))
    try:
        yield
    finally:
        _STATE.pop()


def weights_stay(mesh) -> bool:
    """Whether the active hints are on ``mesh`` and keep its weights put."""
    return bool(_STATE) and _STATE[-1][0] is mesh and _STATE[-1][3]


def active() -> bool:
    return bool(_STATE)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _constrain(x, spec: Optional[P]):
    if spec is None or not is_dtensor(x):
        return x
    from .planner import placements
    mesh = _STATE[-1][0]
    return x.redistribute(mesh, placements(spec, mesh))


def _size(a) -> int:
    return axis_sizes(_STATE[-1][0])[a]


def heads_spec(shape) -> Optional[P]:
    """(B, S, H, hd): batch over dp, heads over tp. None out of context,
    for decode-shaped inputs (S == 1; cache layout rules there), and for
    single-head tensors."""
    if not _STATE or len(shape) != 4 or shape[1] <= 1 or shape[2] <= 1:
        return None
    _, tp, dp, _ = _STATE[-1]
    if _size(tp) <= 1:
        return None
    return P(dp, None, tp, None)


def constrain_heads(x):
    return _constrain(x, heads_spec(tuple(x.shape)))


def seq_q_spec(shape) -> Optional[P]:
    """(B, S, H, hd) query: batch over dp, SEQUENCE over tp — sequence-
    parallel dense attention; k/v full-sequence (``constrain_replicated_kv``)."""
    if not _STATE or len(shape) != 4 or shape[1] <= 1:
        return None
    _, tp, dp, _ = _STATE[-1]
    if _size(tp) <= 1 or shape[1] % _size(tp) != 0:
        return None
    return P(dp, tp, None, None)


def constrain_seq_q(x):
    return _constrain(x, seq_q_spec(tuple(x.shape)))


def replicated_kv_spec(shape) -> Optional[P]:
    """(B, T, KV, hd) keys/values for seq-parallel attention: batch over dp,
    everything else replicated."""
    if not _STATE or len(shape) != 4 or shape[1] <= 1:
        return None
    _, _, dp, _ = _STATE[-1]
    return P(dp, None, None, None)


def constrain_replicated_kv(x):
    return _constrain(x, replicated_kv_spec(tuple(x.shape)))


def tp_size() -> int:
    if not _STATE:
        return 1
    _, tp, _, _ = _STATE[-1]
    return _size(tp)


def moe_group_split(S: int) -> int:
    """Split factor turning seq shards into device-local dispatch groups:
    under sequence parallelism, (G, S, d) -> (G*tp, S/tp, d) is a
    zero-communication relabeling that makes the dispatch LOCAL. It changes
    the groups, and so the capacity, of the routing."""
    tpn = tp_size()
    return tpn if (tpn > 1 and S % tpn == 0) else 1


def experts_spec(shape, expert_axis: int) -> Optional[P]:
    """MoE dispatched tokens, E >= tp: experts over tp, local groups over
    dp."""
    if not _STATE:
        return None
    _, tp, dp, _ = _STATE[-1]
    tpn = _size(tp)
    if tpn <= 1 or shape[expert_axis] % tpn != 0:
        return None
    spec = [None] * len(shape)
    spec[expert_axis] = tp
    if expert_axis == 0 and len(shape) >= 2:
        dpn = 1
        for a in dp:
            dpn *= _size(a)
        if dpn > 1 and shape[1] % dpn == 0:
            spec[1] = dp
    elif expert_axis != 0:
        spec[0] = dp
    return P(*spec)


def constrain_experts(x, expert_axis: int):
    return _constrain(x, experts_spec(tuple(x.shape), expert_axis))


def axes_spec(shape, tp_dims=(), dp_dims=()) -> Optional[P]:
    """Generic: pin listed dims to tp / dp axes (uneven sharding allowed)."""
    if not _STATE:
        return None
    _, tp, dp, _ = _STATE[-1]
    if _size(tp) <= 1:
        return None
    spec = [None] * len(shape)
    for d in tp_dims:
        if shape[d] > 1:
            spec[d] = tp
    for d in dp_dims:
        if dp and shape[d] > 1:
            spec[d] = dp
    return P(*spec)


def constrain_axes(x, tp_dims=(), dp_dims=()):
    return _constrain(x, axes_spec(tuple(x.shape), tp_dims, dp_dims))


def moe_tokens_spec(shape, token_axis: int = 1) -> Optional[P]:
    """MoE dispatched tokens, E < tp: the device-local group dim over
    dp+tp (expert compute is data parallelism over token slots)."""
    if not _STATE:
        return None
    _, tp, dp, _ = _STATE[-1]
    n = _size(tp)
    for a in dp:
        n *= _size(a)
    if n <= 1 or shape[token_axis] % n != 0:
        return None
    spec = [None] * len(shape)
    spec[token_axis] = (*dp, tp)
    return P(*spec)


def constrain_moe_tokens(x, token_axis: int = 1):
    return _constrain(x, moe_tokens_spec(tuple(x.shape), token_axis))


# ---------------------------------------------------------------------------
# ops computed on local tensors, with their placements and their gradients'
# stated: where DTensor has no rule, or its own choice is slow or costly
# ---------------------------------------------------------------------------

def matmul(x, w):
    """``x @ w`` (x (..., K), w (K, N)); on DTensors, in the layout the
    reference's SPMD partitioner reaches, computed on local tensors: w is
    gathered over the dp axes (ZeRO-3's just-in-time gather) and x's rows
    stay split over dp; on tp, w's own split decides — its output dim split
    (column-parallel) takes x whole over tp (the sequence all-gather) and
    gives y split on its last dim; its contraction dim split (row-parallel)
    takes x's last dim split alike and gives y as a partial sum over tp.
    Each rank multiplies its local blocks; the gradients' placements are
    stated (w's a partial sum over the mesh dims that split x's rows, x's
    one over the dims that split w's output). DTensor's own ``mm``
    strategy search was too slow for the dry run on the (2, 16, 16) mesh,
    and its choice moved more collective bytes than this layout. Plain
    tensors multiply as they are.

    Under ``sharding_hints(stationary=True)`` (the decode step: a few rows
    against every weight) no weight moves: a dp axis that splits w's
    contraction dim splits x's last dim alike (x's rows all-to-all'd into
    columns) and gives a partial sum; one that splits w's output dim takes
    x's rows whole (their all-gather) and gives y split on its last dim;
    either is then put back on x's rows (a reduce-scatter, or an
    all-to-all), and a partial sum over tp is summed at once (an
    all-reduce). The bytes moved are the activations', and no gathered
    weight is ever held. Partial sums are taken and summed in f32 and
    rounded once (``_summed_product``), as the unsplit product rounds."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    _, dp = _roles(mesh)
    stay = weights_stay(mesh)
    xl, wl = x.ndim - 1, w.ndim - 1
    xpl, wpl, ypl = list(x.placements), list(w.placements), []
    xgrad, wgrad, final = [], [], []
    for i, a in enumerate(axis_names(mesh)):
        wp = wpl[i]
        if a in dp and isinstance(wp, Shard) and not stay:
            wp = wpl[i] = Replicate()
        col = isinstance(wp, Shard) and wp.dim == wl
        row = isinstance(wp, Shard) and wp.dim == wl - 1
        xp = xpl[i]
        rows = xp if isinstance(xp, Shard) and xp.dim < xl else Replicate()
        if col or xp.is_partial() or (isinstance(xp, Shard) and xp.dim == xl
                                      and not row):
            xp = Replicate()
        if row:
            xp = Shard(xl)
        xpl[i] = xp
        if row:
            ypl.append(Partial())
        elif col:
            ypl.append(Shard(xl))
        else:
            ypl.append(xp)
        final.append(rows if a in dp and (row or col) else
                     Replicate() if stay and row else ypl[-1])
        xgrad.append(Partial() if col else xp)
        wgrad.append(Partial() if isinstance(xp, Shard) and xp.dim < xl
                     else wp)
    x = x.redistribute(mesh, xpl)
    w = w.redistribute(mesh, wpl)
    if stay and Partial() in ypl:
        return _summed_product(x, w, ypl, final)
    y = _wrap(x.to_local(grad_placements=xgrad)
              @ w.to_local(grad_placements=wgrad), x, ypl)
    return y.redistribute(mesh, final) if final != ypl else y


#: Weight elements a product of ``_summed_product`` takes at a time (its
#: f32 copy: 512 KiB of a rank's weight shard, never the shard), and the
#: bytes of f32 partial sums a collective of it takes at a time (1 MiB, of
#: every row a decode brings in, never the whole product's).
F32_WEIGHT_CHUNK, F32_SUM_BYTES = 1 << 17, 1 << 20


def _summed_product(x, w, ypl, final):
    """A stationary product whose output is a partial sum (``matmul``) in
    f32, summed over the ranks (its reduce-scatter or all-reduce) and
    rounded to x's dtype once, as the unsplit product rounds its f32
    accumulation once. w's columns go in groups (each group's partial sums
    summed by one collective: the bytes of the whole product's, in pieces),
    each a chunk of columns at a time (each chunk's weights copied to
    f32)."""
    mesh = w.device_mesh
    mid = [final[i] if p.is_partial() else p for i, p in enumerate(ypl)]
    xf, wl = x.to_local().float(), w.to_local()
    n, rows = wl.shape[-1], max(1, xf[..., 0].numel())
    step = max(1, F32_WEIGHT_CHUNK // max(1, wl.shape[-2]))
    group = max(step, F32_SUM_BYTES // (4 * rows))
    parts = []
    for j in range(0, n, group):
        end = min(j + group, n)
        buf = xf.new_empty((*xf.shape[:-1], end - j))
        for k in range(j, end, step):
            e = min(k + step, end)
            buf[..., k - j:e - j] = xf @ wl[..., k:e].float()
        parts.append(_wrap(buf, x, ypl).redistribute(mesh, mid)
                     .to_local().to(x.dtype))
    y = _wrap(torch.cat(parts, dim=-1), x, mid)
    return y.redistribute(mesh, final) if final != mid else y


def embed(table, tokens):
    """``table[tokens]``; on DTensors, the vocab-parallel lookup computed on
    local tensors: the table gathered over the dp axes (ZeRO-3), the
    tokens' rows left split over dp, and on tp each rank looking up the
    tokens its vocab rows hold (0 for the rest), the rows coming out a
    partial sum over tp. DTensor's own rule for this gather and its
    backward refused the multi-pod mesh's (Shard(0), Shard(0)) tokens and
    a vocab-sharded table (torch 2.11). Under ``sharding_hints(
    stationary=True)`` the table stays put: a dp axis that splits its
    model dim takes every token of its rows (their all-gather) and looks
    up its columns, which go back to the tokens' rows (an all-to-all)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    _, dp = _roles(mesh)
    stay = weights_stay(mesh)
    names = axis_names(mesh)
    if not is_dtensor(tokens):
        tokens = _wrap(tokens, table, [Replicate()] * mesh.ndim)
    tpl, wpl, ypl, wgrad = list(tokens.placements), [], [], []
    final = []
    V = table.shape[0]
    off = 0
    for i, a in enumerate(names):
        wp = table.placements[i]
        vocab = isinstance(wp, Shard) and wp.dim == 0 and a not in dp
        cols = stay and isinstance(wp, Shard) and wp.dim == 1
        rows = tpl[i]
        if (vocab or cols) and isinstance(tpl[i], Shard):
            tpl[i] = Replicate()
        wpl.append(wp if vocab or cols else Replicate())
        ypl.append(Partial() if vocab else
                   Shard(tokens.ndim) if cols else tpl[i])
        final.append(rows if cols else
                     Replicate() if stay and vocab else ypl[-1])
        wgrad.append(wp if vocab else (Partial() if isinstance(tpl[i], Shard)
                                       else Replicate()))
        if vocab:
            off += min(mesh.get_local_rank(i) * -(-V // mesh.size(i)), V)
    tok = tokens.redistribute(mesh, tpl).to_local()
    w = table.redistribute(mesh, wpl).to_local(grad_placements=wgrad)
    idx = tok.long() - off
    hit = (idx >= 0) & (idx < w.shape[0])
    rows = w[idx.clamp(0, w.shape[0] - 1)] * hit[..., None].to(w.dtype)
    y = _wrap(rows, table, ypl)
    return y.redistribute(mesh, final) if final != ypl else y


def unflatten(y, dim: int, sizes: Tuple[int, ...]):
    """``y.unflatten(dim, sizes)``. DTensor cannot split a dim that is cut
    over a mesh dim unevenly in its first new factor (40 heads over a
    16-way tp: 2.5 heads a rank, where GSPMD pads): that cut moves to the
    sequence dim (1) where it divides it, else is gathered."""
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard
        mesh = y.device_mesh
        pl = list(y.placements)
        for i, p in enumerate(pl):
            n = mesh.size(i)
            if isinstance(p, Shard) and p.dim == dim and sizes[0] % n:
                pl[i] = (Shard(1) if dim != 1 and y.shape[1] % n == 0
                         and Shard(1) not in pl else Replicate())
        if pl != list(y.placements):
            y = y.redistribute(mesh, pl)
    return y.unflatten(dim, sizes)


def _roles(mesh) -> Tuple[str, Tuple[str, ...]]:
    """(tp axis, dp axes) of the active context, else the defaults'."""
    if _STATE and _STATE[-1][0] is mesh:
        return _STATE[-1][1], _STATE[-1][2]
    names = axis_names(mesh)
    return "model", tuple(a for a in ("pod", "data") if a in names)


def _batch_placements(mesh, n_batch: int, dp: Sequence[str],
                      extra: Optional[Tuple[str, int]] = None) -> list:
    """Shard(0) on every dp axis when their product divides ``n_batch``,
    ``Shard(dim)`` on ``extra = (axis, dim)``, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    dpn = 1
    for a in dp:
        dpn *= sizes[a]
    out = []
    for a in axis_names(mesh):
        if a in dp and n_batch % dpn == 0:
            out.append(Shard(0))
        elif extra is not None and a == extra[0]:
            out.append(Shard(extra[1]))
        else:
            out.append(Replicate())
    return out


def _wrap(local: torch.Tensor, like, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False)


def heads_local(fn: Callable, q, k, v, **kw):
    """``fn(q, k, v, **kw) -> (B, S, H*hd)`` (``flash_mha``) on DTensor
    q (B,S,H,hd) and k/v (B,T,KV,hd), on each rank's heads and batch rows:
    the reference's ``constrain_heads`` layout, P(dp, None, tp, None)
    whatever H is (batch over dp where B divides it).

    q's heads split over tp as DTensor cuts a dim (``torch.chunk``, where
    GSPMD pads): rank r holds heads [r*c, min((r+1)*c, H)), c = ceil(H/tp),
    so rank 0 holds the most and the last ranks may hold none (40 heads
    over 16: 13 ranks of 3, one of 1, two of 0). Where KV is H, or tp
    divides both H and KV, k/v split alike. Elsewhere k/v stay whole over
    tp and each rank takes by index the KV head each of its query heads
    reads (h // (H/KV)), so ``fn`` runs with one query head a KV head. A
    rank with no head does not call ``fn``.

    The result comes back split on its head dim: on (B, S, H*hd) itself
    where tp divides H (the local heads are one contiguous block of dim 2);
    elsewhere on its (B, S, H, hd) shape, whose flattening DTensor cannot
    express (40 heads over 16 are 2.5 heads of (B, S, H*hd)), so it is
    moved to the sequence dim first where tp divides S (one all-to-all),
    else gathered (one all-gather). The collectives a call adds: q's move
    to its heads (an all-to-all from the sequence-parallel layout), k/v's
    to theirs (a slice, or an all-gather over tp where they stay whole),
    and that one of the result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    tp, dp = _roles(mesh)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    n = axis_sizes(mesh).get(tp, 1)
    pl = _batch_placements(mesh, B, dp, (tp, 2))
    kv_alike = KV == H or (H % n == 0 and KV % n == 0)
    kv_pl = pl if kv_alike else _batch_placements(mesh, B, dp)
    ql = q.redistribute(mesh, pl).to_local()
    kl, vl = (t.redistribute(mesh, kv_pl).to_local() for t in (k, v))
    h = ql.shape[2]
    if not kv_alike:
        h0 = mesh.get_local_rank(axis_names(mesh).index(tp)) * -(-H // n)
        idx = torch.arange(h0, h0 + h, device=kl.device) // (H // KV)
        kl, vl = (t.index_select(2, idx) for t in (kl, vl))
    out = (fn(ql, kl, vl, **kw) if h else
           ql.new_empty((ql.shape[0], S, 0)))
    if H % n == 0:
        return _wrap(out, q, pl)
    # the global shape, which DTensor cannot infer from an uneven split
    y = DTensor.from_local(out.unflatten(2, (h, hd)), mesh, pl,
                           run_check=False, shape=(B, S, H, hd),
                           stride=(S * H * hd, H * hd, hd, 1))
    moved = list(pl)
    moved[axis_names(mesh).index(tp)] = (Shard(1) if S % n == 0
                                         else Replicate())
    return y.redistribute(mesh, moved).flatten(2)


def seq_local(fn: Callable, qs: Sequence, kvs: Sequence):
    """``fn(*qs_local, *kvs_local, q0) -> (B, S_local, ...)``: dense
    attention on each rank's query rows, in the layout of the reference's
    sequence-parallel hints (``constrain_seq_q`` for each of ``qs``,
    (B, S, ·, ·), and ``constrain_replicated_kv`` for each of ``kvs``);
    ``q0`` is the rank's first query row, for the causal mask. The
    gradient of k/v is a partial sum over the ranks that split the
    queries. DTensor's own einsum strategy search for these 5-D products
    was too slow for the dry run on the (2, 16, 16) mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    q = qs[0]
    mesh = q.device_mesh
    tp, dp = _roles(mesh)
    sizes = axis_sizes(mesh)
    S = q.shape[1]
    seq = tp in sizes and sizes[tp] > 1 and S % sizes[tp] == 0
    pl = _batch_placements(mesh, q.shape[0], dp, (tp, 1) if seq else None)
    kv_pl = [p if not (isinstance(p, Shard) and p.dim == 1) else Replicate()
             for p in pl]
    kv_grad = [Partial() if isinstance(p, Shard) and p.dim == 1 else p
               for p in pl]
    q0 = 0
    if seq:
        i = axis_names(mesh).index(tp)
        q0 = mesh.get_local_rank(i) * (S // sizes[tp])
    out = fn(*(t.redistribute(mesh, pl).to_local() for t in qs),
             *(t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
               for t in kvs), q0)
    return _wrap(out, q, pl)


def batch_local(fn: Callable, x, params, *, seq_axis_dim: Optional[int] = None):
    """``fn(x_local, params_local) -> (out, *extra)`` on each rank's batch
    rows: x (B, ...) is redistributed to batch over dp (when dp divides B;
    also dim ``seq_axis_dim`` over tp when given), every DTensor leaf of
    ``params`` to replicated (its gradient a partial sum over the mesh dims
    that split the rows). ``out`` is wrapped back with x's new placements;
    the ``extra`` outputs are returned local. Returns (out, extra,
    placements)."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch._tree import tree_map
    mesh = x.device_mesh
    tp, dp = _roles(mesh)
    extra = (tp, seq_axis_dim) if seq_axis_dim is not None else None
    pl = _batch_placements(mesh, x.shape[0], dp, extra)
    grad_pl = [Replicate() if isinstance(p, Replicate) else Partial()
               for p in pl]
    rep = [Replicate()] * len(pl)

    def local_weight(w):
        if not is_dtensor(w):
            return w
        return w.redistribute(mesh, rep).to_local(grad_placements=grad_pl)

    if hasattr(params, "tree"):
        params = params.tree()
    res = fn(x.redistribute(mesh, pl).to_local(),
             tree_map(local_weight, params))
    out, rest = (res[0], res[1:]) if isinstance(res, tuple) else (res, ())
    return _wrap(out, x, pl), rest, pl


class EP(NamedTuple):
    """The layout ``expert_parallel`` gives the MoE layer's local function.
    ``mode`` is "exchange", "pick" or "stationary" (``expert_parallel``);
    the rank holds experts ``first .. first + n_local - 1`` of the stack.
    In "stationary" mode ``dw`` are the groups of the mesh dims that split
    the stacks' d (wg/wu) and f (wd) dims, in mesh order, and ``d_slice``
    is this rank's columns of d."""
    mode: str
    first: int
    n_local: int
    tp: int
    tp_group: object
    dw: Tuple[object, ...] = ()
    d_slice: slice = slice(None)


def expert_parallel(fn: Callable, x, params):
    """Expert parallelism for a stacked MoE layer whose expert dim tp splits
    (``E % tp == 0``; the planner gives the stacks P(tp, fsdp, None)): each
    rank computes its own E/tp experts only, and no expert weight moves
    over tp in either direction. ``fn(x_local, params_local, ep) -> (out,
    *stats)`` does the routing and the experts (``ep``: an ``EP``);
    ``params`` holds the router and the stacks (wg, wu, wd). x is (G, S, d)
    (dispatch groups; under sequence parallelism the reference's (G·tp,
    S/tp) groups are the rank's (G/dp, S/tp) rows). Returns (out on x's
    rows, the stats as DTensors summed over the ranks that split the
    rows).

    The rows' placement picks the mode:
      * "exchange": the rows split over tp (the sequence, S % tp == 0), or
        a tp of one rank (a one-rank all-to-all). x goes to the rank's
        rows (G/dp, S/tp, d); ``fn`` builds the static (E, G/dp, C, d)
        dispatch buffer of them and ``to_experts`` sends each owner its
        experts' block (one all-to-all over tp of E·(G/dp)·C·d elements a
        rank; its gradient the reverse one); ``from_experts`` returns the
        outputs (the same bytes again).
      * "pick": the rows whole over tp > 1 (a prefill whose S does not
        divide over tp). Each rank takes the choices routed to its own
        experts from its rows; ``fn`` returns their gate-weighted f32 sum,
        which is summed over tp and rounded to x's dtype once here (one
        all-reduce of (G/dp)·S·d f32). The router's statistics are taken
        on tp rank 0 only (each tp rank holds the same rows), so the
        gradients of the router and x are partial sums over tp.
      * "stationary" (under ``sharding_hints(stationary=True)``: the decode
        step, where a tp of more than one rank or a dp split of the
        stacks would otherwise move them): the stacks stay where they lie.
        x's rows are all-gathered over the mesh dims that split the stacks'
        d (``dw``: R rows of B/dp x d a rank); ``fn`` multiplies every row
        by every local expert on the rank's d columns (wg/wu) and f rows
        (wd), and sums the f32 partial products of wg/wu over ``dw`` with
        ``dw_sum`` (a reduce-scatter onto f of K·R·2f f32); it returns the
        gate-weighted f32 partial output, which is reduce-scattered onto
        x's rows over ``dw`` (R·d f32) and all-reduced over tp ((B/dp)·d
        f32) here, and rounded to x's dtype once.
    In "exchange" and "pick" the local stacks (E/tp, d/dp, f) are
    all-gathered over the dp axes only (ZeRO-3, E/tp·d·f elements a stack)
    and their gradient reduce-scattered back over dp; the router (d, E) is
    all-gathered whole, its gradient a partial sum over the ranks that
    split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    tp, dp = _roles(mesh)
    names = axis_names(mesh)
    if tp not in names:
        raise ValueError(f"expert parallelism needs the tp axis {tp!r} in "
                         f"the mesh {names}")
    t = names.index(tp)
    n_tp = mesh.size(t)
    stacks = [params[k] for k in ("wg", "wu", "wd")]
    E = stacks[0].shape[0]
    for w in stacks:
        if (not is_dtensor(w) or w.placements != stacks[0].placements
                or (n_tp > 1 and w.placements[t] != Shard(0))):
            raise ValueError(f"expert parallelism over {n_tp} tp ranks "
                             f"needs the three expert stacks split alike, "
                             f"on their expert dim over tp; got "
                             f"{getattr(w, 'placements', 'a plain tensor')}")
    dw = [i for i, p in enumerate(stacks[0].placements)
          if i != t and isinstance(p, Shard) and mesh.size(i) > 1]
    seq = moe_group_split(x.shape[1]) > 1
    if weights_stay(mesh) and (n_tp > 1 or dw):
        mode = "stationary"
    elif n_tp > 1 and not seq:
        mode = "pick"
    else:
        mode = "exchange"
    pl = _batch_placements(mesh, x.shape[0], dp,
                           (tp, 1) if mode == "exchange" and seq else None)
    # the ranks that hold copies of the same rows take the routing's
    # statistics once: rank 0 of tp in "pick"
    stat_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    first = mesh.get_local_rank(t) * (E // n_tp) if n_tp > 1 else 0
    ep = EP(mode, first, E // n_tp, n_tp, mesh.get_group(t))
    rep = [Replicate()] * mesh.ndim
    if mode == "stationary":
        rows_pl = [Replicate() if i in dw else p for i, p in enumerate(pl)]
        stat_pl = [Partial() if isinstance(p, Shard) else Replicate()
                   for p in rows_pl]
        # the rank's columns of d: each dim in dw cuts the previous cut's
        # block evenly, in mesh order (the planner splits only where it
        # divides)
        size, off = stacks[0].shape[1], 0
        for i in dw:
            size //= mesh.size(i)
            off += mesh.get_local_rank(i) * size
        ep = ep._replace(dw=tuple(mesh.get_group(i) for i in dw),
                         d_slice=slice(off, off + size))
        xl = x.redistribute(mesh, rows_pl).to_local()
        local = {k: params[k].to_local() for k in ("wg", "wu", "wd")}
    else:
        grad_x = list(pl)
        if mode == "pick":
            grad_x[t] = stat_pl[t] = Partial()
        xl = x.redistribute(mesh, pl).to_local(grad_placements=grad_x)
        local = {}
        for k, w in zip(("wg", "wu", "wd"), stacks):
            keep = [w.placements[t] if i == t else Replicate()
                    for i in range(mesh.ndim)]
            grad = [w.placements[t] if i == t else
                    Partial() if isinstance(pl[i], Shard) else Replicate()
                    for i in range(mesh.ndim)]
            local[k] = w.redistribute(mesh, keep).to_local(
                grad_placements=grad)
    router = params["router"]
    if is_dtensor(router):
        router = router.redistribute(mesh, rep).to_local(
            grad_placements=[Partial() if p.is_partial() else Replicate()
                             for p in stat_pl])
    out, *stats = fn(xl, {"router": router, **local}, ep)
    if mode == "pick" and mesh.get_local_rank(t) != 0:
        # zeros with the same graph behind them: every rank's backward
        # runs the same collectives
        stats = [s * 0 for s in stats]
    stats = [_wrap(s, x, stat_pl) for s in stats]
    if mode == "exchange":
        return _wrap(out, x, pl), stats
    # an f32 partial sum over tp (and over dw): summed onto x's rows, and
    # rounded once
    part = [Partial() if i == t or (mode == "stationary" and i in dw)
            else (rows_pl[i] if mode == "stationary" else p)
            for i, p in enumerate(pl)]
    out = _wrap(out, x, part).redistribute(mesh, pl).to(x.dtype)
    return out, stats


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """One all-to-all of ``t`` over ``group``, dim 0 cut in equal blocks
    (block i to rank i); its gradient the reverse all-to-all."""
    import torch.distributed._functional_collectives as fc
    if torch.is_grad_enabled() and t.requires_grad:
        return fc.all_to_all_single_autograd(t, None, None, group)
    return fc.all_to_all_single(t, None, None, group)


def to_experts(buf: torch.Tensor, ep: EP) -> torch.Tensor:
    """The exchange: the rank's dispatch buffer (E, n, d) to its owners,
    experts ``r·E/tp ..`` to tp rank r; returns (E/tp, tp·n, d), the rows
    every tp rank sent to this rank's experts, in rank order. One
    all-to-all over tp of E·n·d elements a rank."""
    _, n, d = buf.shape
    y = _all_to_all(buf.contiguous(), ep.tp_group)
    return y.view(ep.tp, ep.n_local, n, d).transpose(0, 1).reshape(
        ep.n_local, ep.tp * n, d)


def from_experts(y: torch.Tensor, ep: EP) -> torch.Tensor:
    """The exchange's return: the local experts' outputs (E/tp, tp·n, d)
    back to the ranks that sent the rows; returns (E, n, d) for this
    rank's rows, in expert order. One all-to-all over tp of E·n·d
    elements a rank."""
    m, d = y.shape[1:]
    n = m // ep.tp
    z = y.view(ep.n_local, ep.tp, n, d).transpose(0, 1).reshape(
        ep.tp * ep.n_local, n, d)
    return _all_to_all(z, ep.tp_group)


def dw_sum(t: torch.Tensor, dim: int, ep: EP) -> torch.Tensor:
    """Partial sums over the mesh dims that split the experts' d
    ("stationary"), summed and cut on ``dim`` as those dims cut the
    stacks' f (a reduce-scatter over each, in mesh order, of ``t``'s
    elements): each rank keeps the f rows of wd it holds."""
    import torch.distributed._functional_collectives as fc
    for g in ep.dw:
        t = fc.reduce_scatter_tensor(t, "sum", dim, g)
    return t


def partial_sum(local: torch.Tensor, like, placements):
    """A DTensor of ``local`` that sums over the mesh dims ``placements``
    shard (and is replicated over the rest): each rank's share of a sum
    over the rows ``batch_local`` gave it."""
    from torch.distributed.tensor import Partial, Replicate
    return _wrap(local, like, [Replicate() if isinstance(p, Replicate)
                               else Partial() for p in placements])


# ---------------------------------------------------------------------------
# the decode step on a mesh: the cache leaves are DTensors placed by
# planner.cache_sharding, each rank reads and writes its own shard only
# ---------------------------------------------------------------------------

def _tp_dim(mesh) -> int:
    return axis_names(mesh).index(_roles(mesh)[0])


def row_placements(x) -> list:
    """The placements of a decode activation's rows: batch over the dp
    axes (when they divide it), whole over tp."""
    mesh = x.device_mesh
    return _batch_placements(mesh, x.shape[0], _roles(mesh)[1])


def rows(x) -> torch.Tensor:
    """The rank's batch rows of DTensor ``x`` (B, ...) with every other dim
    whole: the all-gather over tp of what tp splits (a token's q, k, v or
    gate: B/dp x a few KB)."""
    return x.redistribute(x.device_mesh, row_placements(x)).to_local()


def wrap_rows(local: torch.Tensor, like) -> "torch.Tensor":
    """``local`` (the rank's rows, every other dim whole) as a DTensor."""
    return _wrap(local, like, row_placements(like))


def cache_local(leaf, name: str, dims: Sequence[int]):
    """(local shard, the dim tp splits or None, the rank's index along tp,
    the tp size) of a cache leaf (B, ...): its rows as ``row_placements``
    gives them, and over tp either whole or split on one of ``dims``. Any
    other placement raises ValueError naming the leaf: a leaf is never
    gathered."""
    from torch.distributed.tensor import Shard
    mesh = leaf.device_mesh
    want = _batch_placements(mesh, leaf.shape[0], _roles(mesh)[1])
    t = _tp_dim(mesh)
    # a mesh dim of one rank splits nothing, whatever its placement says
    ok = all(p == want[i] or mesh.size(i) == 1
             for i, p in enumerate(leaf.placements) if i != t)
    p = leaf.placements[t]
    split = p.dim if isinstance(p, Shard) and mesh.size(t) > 1 else None
    if not ok or not (split is None and not p.is_partial()
                      or split in dims):
        raise ValueError(f"cache leaf {name!r} {tuple(leaf.shape)}: "
                         f"placements {tuple(leaf.placements)} match no "
                         f"decode rule (rows {tuple(want)}, tp whole or "
                         f"split on dim {tuple(dims)})")
    if split is not None and leaf.shape[split] % mesh.size(t):
        raise ValueError(f"cache leaf {name!r}: dim {split} "
                         f"({leaf.shape[split]}) does not divide over tp")
    n = mesh.size(t) if split is not None else 1
    return leaf.to_local(), split, mesh.get_local_rank(t) if n > 1 else 0, n


def like_state(x, state) -> torch.Tensor:
    """DTensor ``x`` in the placements of a recurrent state leaf of the same
    rank (its rows; over tp its feature slice, or whole), as the local
    tensor: an all-gather over tp where x is split and the state whole,
    a slice where it is the other way round."""
    return x.redistribute(state.device_mesh, list(state.placements)).to_local()


def tp_slice(w, dim: Optional[int]) -> torch.Tensor:
    """Local DTensor weight ``w`` whole on every mesh dim but tp, where it
    is split on ``dim`` (whole for None): the slice that meets a state
    split alike. An all-gather over dp where the planner splits it there
    (RG-LRU's conv kernel is not)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    pl = [Replicate()] * mesh.ndim
    if dim is not None:
        pl[_tp_dim(mesh)] = Shard(dim)
    return w.redistribute(mesh, pl).to_local()


def as_dtensor(local: torch.Tensor, like, placements=None):
    """``local`` as a DTensor on ``like``'s mesh with ``placements``
    (default: replicated on every mesh dim); ``local`` itself where
    ``like`` is a plain tensor."""
    if not is_dtensor(like):
        return local
    if placements is None:
        from torch.distributed.tensor import Replicate
        placements = [Replicate()] * like.device_mesh.ndim
    return _wrap(local, like, placements)


def tp_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of local ``t`` over the tp axis: one all-reduce."""
    import torch.distributed._functional_collectives as fc
    return fc.all_reduce(t, "sum", mesh.get_group(_tp_dim(mesh)))


def tp_gather(t: torch.Tensor, dim: int, like) -> torch.Tensor:
    """Local ``t`` (each rank's slice of ``dim``) gathered whole over tp,
    in rank order: one all-gather."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = like.device_mesh
    pl = [Replicate()] * mesh.ndim
    pl[_tp_dim(mesh)] = Shard(dim)
    return _wrap(t, like, pl).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def seq_decode(partial: Callable, qs: Sequence, caches, news, slot: int,
               params=None):
    """The distributed flash-decode over cache leaves whose sequence dim (1)
    is split over tp (``planner.cache_sharding`` picks it, the largest).

    ``caches`` and ``news`` map each leaf's name to the DTensor leaf
    (B, T, ...) and to its new entry (B, 1, ...) in the leaf's dtype.
    * the write: the rank whose shard holds global ``slot`` writes the new
      entry in place at ``slot - rank * T/tp``; every other shard is left
      as it was. The new entries reach the rows' ranks first (an
      all-gather over tp of B/dp x one entry).
    * the partial attention: ``partial(q_locals, cache_locals, kpos,
      params_local) -> (m, l, o)``, the f32 running max (B_l, X), sum of
      exps (B_l, X) and unnormalized output (B_l, X, D) of the rank's
      queries (every head: ``qs`` are all-gathered over tp, B_l x H x hd)
      against its keys at global positions ``kpos``; ``params`` (small
      leaves, MLA's up-projection) reach it whole (their all-gather).
    * the combine, over tp: all_reduce(MAX) of m (B_l·X f32), then one
      all_reduce(SUM) of [l·e^(m−M) | o·e^(m−M)] (B_l·X·(D+1) f32). A rank
      whose keys are all masked has m = NEG_INF and weighs exactly 0.
    Returns o / l, (B, X, D) f32, as a DTensor on the rows. A cache whole
    over tp takes the same path without the combine."""
    from torch.distributed.tensor import Replicate
    from repro_torch._tree import tree_map
    import torch.distributed._functional_collectives as fc
    q = qs[0]
    mesh = q.device_mesh
    pl = row_placements(q)
    local, split = {}, set()
    for name, leaf in caches.items():
        loc, dim, r, n = cache_local(leaf, name, (1,))
        local[name] = loc
        split.add((dim, r, n))
    if len(split) != 1:
        raise ValueError(f"cache leaves {list(caches)} split apart: {split}")
    dim, r, n = split.pop()
    Tl = next(iter(local.values())).shape[1]
    k0 = r * Tl
    new = {k: v.redistribute(mesh, pl).to_local() for k, v in news.items()}
    if k0 <= slot < k0 + Tl:
        for k, loc in local.items():
            loc[:, slot - k0] = new[k][:, 0]
    ql = [t.redistribute(mesh, pl).to_local() for t in qs]
    rep = [Replicate()] * mesh.ndim

    def whole(w):
        return w.redistribute(mesh, rep).to_local() if is_dtensor(w) else w

    pp = None if params is None else tree_map(whole, _as_tree(params))
    kpos = k0 + torch.arange(Tl, device=ql[0].device)
    m, l, o = partial(ql, list(local.values()), kpos, pp)
    if n > 1:
        g = mesh.get_group(_tp_dim(mesh))
        w = torch.exp(m - fc.all_reduce(m, "max", g))
        lo = fc.all_reduce(torch.cat([(l * w)[..., None],
                                      o * w[..., None]], dim=-1), "sum", g)
        l, o = lo[..., 0], lo[..., 1:]
    return _wrap(o / l[..., None], q, pl)


def _as_tree(params):
    """A dict of weights with every module (``_Tree``) read as its dict."""
    if hasattr(params, "tree"):
        return params.tree()
    if isinstance(params, dict):
        return {k: _as_tree(v) for k, v in params.items()}
    return params


def expert(w, e: int):
    """Expert ``e`` of a stacked DTensor weight (E, a, b) as a DTensor
    (a, b), its other splits kept (a view), for the token-parallel MoE
    (``E % tp != 0``: the planner splits d_ff over tp, never the expert
    dim); ``w[e]`` of a plain tensor. A stack whose expert dim a mesh dim
    of more than one rank splits raises: its experts run where they lie
    (``expert_parallel``), and one rank's block never leaves it."""
    if not is_dtensor(w):
        return w[e]
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    ax = [i for i, p in enumerate(w.placements)
          if isinstance(p, Shard) and p.dim == 0 and mesh.size(i) > 1]
    if ax:
        raise ValueError(f"expert {e} of a stack split on its expert dim "
                         f"over mesh dims {ax}: run it expert-parallel "
                         f"(expert_parallel)")
    return w[e]


__all__ = ["sharding_hints", "active", "is_dtensor", "constrain_heads",
           "constrain_seq_q", "constrain_replicated_kv", "tp_size",
           "moe_group_split", "constrain_experts", "constrain_axes",
           "constrain_moe_tokens", "heads_spec", "seq_q_spec",
           "replicated_kv_spec", "experts_spec", "axes_spec",
           "moe_tokens_spec", "heads_local", "batch_local", "partial_sum",
           "weights_stay", "row_placements", "rows", "wrap_rows",
           "cache_local", "as_dtensor", "like_state", "tp_slice",
           "tp_sum", "tp_gather", "seq_decode", "expert", "EP",
           "expert_parallel", "to_experts", "from_experts", "dw_sum"]
