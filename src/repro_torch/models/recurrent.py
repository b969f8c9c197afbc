"""Recurrent blocks: the JAX package's ``src/repro/models/recurrent.py`` —
RG-LRU (RecurrentGemma/Griffin) and xLSTM (mLSTM + sLSTM).

Each has a sequence form for the prefill and a one-step form for decode:
  * RG-LRU's sequence form is the reference's associative scan
    of the linear recurrence h_t = a_t h_{t-1} + b_t: here a log-depth
    Hillis-Steele scan in f32 (ceil(log2 S) doubling steps over the whole
    sequence, no loop over positions);
  * mLSTM's is the chunkwise form (parallel within a chunk, a loop over the
    S / chunk chunks carrying the matrix memory);
  * sLSTM is sequential by nature (h_{t-1} feeds the gates): a Python loop
    over time, the reference's ``lax.scan``. The input half of each gate
    (x_t @ w) does not depend on h, so it is one product over the whole
    sequence before the loop.
None of these is a Pallas kernel in the reference; they are plain PyTorch
here on every device.

On a mesh (the decode state's leaves DTensors placed by
``planner.cache_sharding``: rows over dp, the feature dim over tp or whole)
each step's projections stay DTensor products and the recurrence runs on
the rank's feature slice (``*_on_mesh``): elementwise updates on the
slice, a partial sum where the step contracts the split dim (the mLSTM's
normalizer), an all-gather where it needs the whole vector (the mLSTM's
read-out, the sLSTM's recurrent product). Each rank writes its slice of
the state in place.

The reference's simplifications are kept (sigmoid input/forget gates with a
max-normalizer in the mLSTM; a width-4 depthwise conv in the RG-LRU block),
as are its clamps and its tanh-form GELU. Leaves the reference uses in f32
(RG-LRU's ``lam``, the sLSTM's six gate matrices, the mLSTM's norm scale)
are made f32 by the inits here whatever ``dtype`` the matmul weights take.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import shardctx
from .blocks import Params, _init, dense, dense_init, rmsnorm, rmsnorm_init

F32 = torch.float32


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # The reference's GELU is the tanh approximation (its default).
    return F.gelu(x, approximate="tanh")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # The reference's softplus is logaddexp(x, 0).
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: Optional[int] = None       #: recurrence width (default d_model)
    conv_width: int = 4

    @property
    def width(self) -> int:
        return self.d_rnn or self.d_model


def rglru_lam(w: int, device=None) -> torch.Tensor:
    """The reference's deterministic ``lam``: softplus^-1 of -log(a)/C for
    a spaced evenly in (0.9, 0.999), in f32."""
    a = torch.linspace(0.9, 0.999, w, dtype=F32, device=device)
    return torch.log(torch.expm1(-torch.log(a) / RGLRU_C))


def rglru_init(gen, cfg: RGLRUConfig, dtype=F32, device=None) -> Params:
    d, w = cfg.d_model, cfg.width
    kw = dict(dtype=dtype, device=device)
    return {
        "wx": dense_init(gen, d, w, **kw),          # recurrent branch in-proj
        "wy": dense_init(gen, d, w, **kw),          # gate branch in-proj
        "conv": _init(gen, (cfg.conv_width, w), scale=0.3, **kw),
        "wa": dense_init(gen, w, w, **kw),          # recurrence gate
        "wi": dense_init(gen, w, w, **kw),          # input gate
        "lam": rglru_lam(w, device),
        "wo": dense_init(gen, w, d, **kw),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, w) recurrent state, f32
    conv: torch.Tensor    # (B, conv_width-1, w) trailing inputs


def rglru_init_state(cfg: RGLRUConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> RGLRUState:
    w = cfg.width
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=F32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device))


def _rglru_gates(p: Params, xb: torch.Tensor):
    """a_t and the gated input of the linear recurrence, both f32."""
    r = torch.sigmoid(dense(p["wa"], xb).float())
    i = torch.sigmoid(dense(p["wi"], xb).float())
    log_a = -RGLRU_C * r * _softplus(p["lam"].float())      # log a_t <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xb.float())
    return a, gated


def _causal_depthwise_conv(x: torch.Tensor, kernel: torch.Tensor,
                           prefix: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """x (B,S,w), kernel (W,w) -> causal depthwise conv, optional state.
    The reference's sum of W products in x's dtype, term by term."""
    W = kernel.shape[0]
    S = x.shape[1]
    pre = (prefix if prefix is not None
           else x.new_zeros((x.shape[0], W - 1, x.shape[2])))
    xp = torch.cat([pre, x], dim=1)
    k = kernel.to(x.dtype)
    out = xp[:, 0:S] * k[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * k[i]
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, in
    ceil(log2 S) doubling steps (Hillis-Steele): after the step of offset
    o, position t holds the composition of positions t - 2o + 1 .. t, so
    (a, b) there combine with those o back as the reference's
    ``combine(c1, c2) = (a2 a1, a2 b1 + b2)``."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:],
                                                 b[:, :-off])], dim=1)
        if 2 * off < S:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_block(p: Params, x: torch.Tensor, cfg: RGLRUConfig
                ) -> torch.Tensor:
    """Sequence form. x (B,S,d) -> (B,S,d), the scan over S in f32."""
    gate = _gelu(dense(p["wy"], x))
    xb = _causal_depthwise_conv(dense(p["wx"], x), p["conv"])
    a, gated = _rglru_gates(p, xb)                 # (B,S,w) f32
    h = linear_scan(a, gated)
    return dense(p["wo"], h.to(x.dtype) * gate)


def rglru_step(p: Params, x: torch.Tensor, state: RGLRUState,
               cfg: RGLRUConfig) -> Tuple[torch.Tensor, RGLRUState]:
    """Decode form. x (B,1,d); O(1) state update."""
    gate = _gelu(dense(p["wy"], x))
    xin = dense(p["wx"], x)
    if shardctx.is_dtensor(state.h):
        return _rglru_step_on_mesh(p, x, state, gate, xin)
    xb = _causal_depthwise_conv(xin, p["conv"], prefix=state.conv)
    new_conv = torch.cat([state.conv, xin], dim=1)[:, 1:]
    a, gated = _rglru_gates(p, xb)
    h = a[:, 0] * state.h + gated[:, 0]
    y = dense(p["wo"], h[:, None].to(x.dtype) * gate)
    return y, RGLRUState(h=h, conv=new_conv)


def _rglru_step_on_mesh(p: Params, x, state: RGLRUState, gate, xin
                        ) -> Tuple[torch.Tensor, RGLRUState]:
    """``rglru_step`` on a mesh: the conv window and the recurrence on the
    rank's slice of the width (the state's placements), elementwise; the
    gates' products take the conv output whole over tp (``dense``).
    ``conv`` and ``h`` are written in place (each may be split or whole
    over tp, independently: recurrentgemma's tail ``h`` is whole)."""
    conv, csplit, _, _ = shardctx.cache_local(state.conv, "conv", (2,))
    h, _, _, _ = shardctx.cache_local(state.h, "h", (1,))
    xl = shardctx.like_state(xin, state.conv)                  # (B_l,1,w_c)
    kern = shardctx.tp_slice(p["conv"], None if csplit is None else 1)
    xb = _causal_depthwise_conv(xl, kern, prefix=conv)
    conv.copy_(torch.cat([conv, xl], dim=1)[:, 1:])
    a, gated = _rglru_gates(p, shardctx.as_dtensor(xb, state.conv,
                                                   state.conv.placements))
    h.copy_(shardctx.like_state(a[:, 0], state.h) * h
            + shardctx.like_state(gated[:, 0], state.h))
    y = dense(p["wo"], state.h[:, None].to(x.dtype) * gate)
    return y, state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory) — chunkwise linear attention with decay
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    chunk: int = 128
    up_factor: int = 2

    @property
    def d_inner(self) -> int:
        return self.up_factor * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def mlstm_init(gen, cfg: MLSTMConfig, dtype=F32, device=None) -> Params:
    d, di = cfg.d_model, cfg.d_inner
    kw = dict(dtype=dtype, device=device)
    return {
        "wup": dense_init(gen, d, di, **kw),
        "wgate": dense_init(gen, d, di, **kw),
        "wq": dense_init(gen, di, di, **kw),
        "wk": dense_init(gen, di, di, **kw),
        "wv": dense_init(gen, di, di, **kw),
        "wf": dense_init(gen, di, cfg.n_heads, **kw),  # forget gate (per head)
        "wi": dense_init(gen, di, cfg.n_heads, **kw),  # input gate (per head)
        "norm": rmsnorm_init(di, device=device),
        "wdown": dense_init(gen, di, d, **kw),
    }


class MLSTMState(NamedTuple):
    S: torch.Tensor      # (B, H, hd, hd) matrix memory, f32
    n: torch.Tensor      # (B, H, hd) normalizer, f32


def mlstm_init_state(cfg: MLSTMConfig, batch: int,
                     device=None) -> MLSTMState:
    H, hd = cfg.n_heads, cfg.head_dim
    return MLSTMState(S=torch.zeros((batch, H, hd, hd), dtype=F32,
                                    device=device),
                      n=torch.zeros((batch, H, hd), dtype=F32, device=device))


def _mlstm_qkvgates(p: Params, x: torch.Tensor, cfg: MLSTMConfig,
                    heads: bool = True):
    """q, k, v (B, S, H, hd), or (B, S, H*hd) without ``heads``; the
    gates f, i (B, S, H) f32; the output gate (B, S, H*hd)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    up = dense(p["wup"], x)
    gate = F.silu(dense(p["wgate"], x))
    q = dense(p["wq"], up) / math.sqrt(hd)
    k = dense(p["wk"], up) / math.sqrt(hd)
    v = dense(p["wv"], up)
    if heads:
        q, k, v = (t.reshape(B, S, H, hd) for t in (q, k, v))
    f = torch.sigmoid(dense(p["wf"], up).float())            # (B,S,H)
    i = torch.sigmoid(dense(p["wi"], up).float())
    return q, k, v, f, i, gate


def mlstm_block(p: Params, x: torch.Tensor, cfg: MLSTMConfig
                ) -> torch.Tensor:
    """Chunkwise form: a loop over S/chunk chunks carrying (S, n)."""
    B, S, _ = x.shape
    H, hd, Q = cfg.n_heads, cfg.head_dim, min(cfg.chunk, S)
    if S % Q:
        raise ValueError(f"S={S}: pad the sequence to the mLSTM chunk {Q}")
    q, k, v, f, i, gate = _mlstm_qkvgates(p, x, cfg)
    Sm = torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=F32, device=x.device)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    hs = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        qc, kc, vc = (t[:, sl].float() for t in (q, k, v))   # (B,Q,H,hd)
        fc, ic = f[:, sl], i[:, sl]                           # (B,Q,H)
        cum = torch.cumsum(torch.log(torch.clamp_min(fc, 1e-9)), dim=1)
        g = torch.exp(cum)                                    # (B,Q,H)
        total = torch.exp(cum[:, -1])                         # (B,H)
        # decay ratio D[t,s] = g_t / g_s for s <= t (log space, masked).
        # The mask goes in before the exp: the reference exponentiates the
        # whole (Q, Q) and masks after, which overflows above the diagonal
        # once a chunk decays by more than ~88 nats; the forward hides the
        # inf, its gradient (0 * inf) does not. The values are the same.
        dl = cum[:, :, None, :] - cum[:, None, :, :]          # (B,Q,Q,H)
        D = torch.exp(torch.where(tri[None, :, :, None], dl, -math.inf))
        att = torch.einsum("bthd,bshd->bhts", qc, kc)
        att = att * D.permute(0, 3, 1, 2)                     # (B,H,Q,Q)
        att = att * ic.permute(0, 2, 1)[:, :, None, :]        # weight by i_s
        out_intra = torch.einsum("bhts,bshd->bthd", att, vc)
        qg = qc * g[..., None]
        out_inter = torch.einsum("bthd,bhde->bthe", qg, Sm)
        n_inter = torch.einsum("bthd,bhd->bth", qg, n)
        # q_t . n_t^intra == sum_s att[t, s] (same decay/gate weighting)
        n_intra = att.sum(dim=-1).permute(0, 2, 1)            # (B,Q,H)
        denom = torch.clamp_min((n_inter + n_intra).abs(), 1.0)[..., None]
        hs.append((out_inter + out_intra) / denom)
        # S' = total S + sum_s (total / g_s) i_s k_s v_s^T
        w_s = (total[:, None] / torch.clamp_min(g, 1e-30)) * ic
        Sm = total[..., None, None] * Sm + torch.einsum(
            "bsh,bshd,bshe->bhde", w_s, kc, vc)
        n = total[..., None] * n + torch.einsum("bsh,bshd->bhd", w_s, kc)
    h = torch.cat(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    h = rmsnorm(p["norm"], h) * gate
    return dense(p["wdown"], h)


def mlstm_step(p: Params, x: torch.Tensor, state: MLSTMState,
               cfg: MLSTMConfig) -> Tuple[torch.Tensor, MLSTMState]:
    """Decode form: S' = f S + i k v^T; h = (q S') / max(|q n'|, 1)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    if shardctx.is_dtensor(state.S):
        return _mlstm_step_on_mesh(p, x, state, cfg)
    q, k, v, f, i, gate = _mlstm_qkvgates(p, x, cfg)
    q1, k1, v1 = (t[:, 0].float() for t in (q, k, v))
    f1, i1 = f[:, 0], i[:, 0]                      # (B,H)
    S2 = (f1[..., None, None] * state.S
          + i1[..., None, None] * k1[..., :, None] * v1[..., None, :])
    n2 = f1[..., None] * state.n + i1[..., None] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, S2)
    den = torch.clamp_min(torch.einsum("bhd,bhd->bh", q1, n2).abs(), 1.0)
    h = (num / den[..., None]).reshape(B, 1, H * hd).to(x.dtype)
    h = rmsnorm(p["norm"], h) * gate
    return dense(p["wdown"], h), MLSTMState(S=S2, n=n2)


def _mlstm_step_on_mesh(p: Params, x, state: MLSTMState, cfg: MLSTMConfig
                        ) -> Tuple[torch.Tensor, MLSTMState]:
    """``mlstm_step`` on a mesh, ``S`` split over tp on its last dim (e, v's)
    and ``n`` on its last (d, k's), or both whole. q, k, v and the gates of
    the rank's rows come whole (their all-gather over tp, B_l x 3 H hd).
    S' and n' are elementwise on the slices; q S' contracts d, which is
    whole, so the read-out's e slice is local; q . n' contracts the split
    d: a partial sum, one all-reduce (B_l x H f32). The read-out is
    gathered over tp (B_l x H hd f32) for the norm. S and n are written in
    place."""
    H, hd = cfg.n_heads, cfg.head_dim
    S, _, r, n = shardctx.cache_local(state.S, "S", (3,))
    nn_, _, r2, n2 = shardctx.cache_local(state.n, "n", (2,))
    if (r, n) != (r2, n2):
        raise ValueError(f"mLSTM state split apart: S {state.S.placements},"
                         f" n {state.n.placements}")
    q, k, v, f, i, gate = _mlstm_qkvgates(p, x, cfg, heads=False)
    q1, k1, v1 = (shardctx.rows(t)[:, 0].float().reshape(-1, H, hd)
                  for t in (q, k, v))
    f1, i1 = (shardctx.rows(t)[:, 0] for t in (f, i))       # (B_l,H)
    w = S.shape[-1]
    sl = slice(r * w, (r + 1) * w)
    S.copy_(f1[..., None, None] * S
            + i1[..., None, None] * k1[..., :, None] * v1[..., None, sl])
    nn_.copy_(f1[..., None] * nn_ + i1[..., None] * k1[..., sl])
    num = torch.einsum("bhd,bhde->bhe", q1, S)
    den = torch.einsum("bhd,bhd->bh", q1[..., sl], nn_)
    if n > 1:
        den = shardctx.tp_sum(den, state.S.device_mesh)
        num = shardctx.tp_gather(num, 2, state.S)
    h = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    h = shardctx.wrap_rows(h.reshape(h.shape[0], 1, H * hd).to(x.dtype), x)
    h = rmsnorm(p["norm"], h) * gate
    return dense(p["wdown"], h), state


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory; sequential — gate feedback)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int
    ff_factor: float = 4.0 / 3.0


#: The gate matrices, input half then recurrent half, in the order z, i, f.
SLSTM_GATES = ("wz", "wi", "wf")
SLSTM_RECURRENT = ("rz", "ri", "rf")


def slstm_init(gen, cfg: SLSTMConfig, dtype=F32, device=None) -> Params:
    """The six gate matrices in f32 (the reference casts them to f32 at
    every step); ``wo`` and the FFN in ``dtype``."""
    d = cfg.d_model
    dff = int(cfg.ff_factor * d)
    kw = dict(dtype=dtype, device=device)
    p = {}
    for w, r in zip(SLSTM_GATES, SLSTM_RECURRENT):
        p[w] = dense_init(gen, d, d, dtype=F32, device=device)
        p[r] = dense_init(gen, d, d, dtype=F32, device=device)
    p["wo"] = dense_init(gen, d, d, **kw)
    p["ffn_up"] = dense_init(gen, d, dff, **kw)
    p["ffn_dn"] = dense_init(gen, dff, d, **kw)
    return p


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) f32
    n: torch.Tensor   # (B, d) f32
    h: torch.Tensor   # (B, d) f32


def slstm_init_state(cfg: SLSTMConfig, batch: int,
                     device=None) -> SLSTMState:
    z = torch.zeros((batch, cfg.d_model), dtype=F32, device=device)
    return SLSTMState(c=z, n=z.clone(), h=z.clone())


def _gate_weights(p: Params, names) -> torch.Tensor:
    """(d, 3d) f32: the three gates' matrices side by side."""
    return torch.cat([p[k]["w"].float() for k in names], dim=1)


def _slstm_cell(gx: torch.Tensor, r: torch.Tensor,
                st: SLSTMState) -> SLSTMState:
    """One step. gx (B, 3d) f32 is x_t @ [wz | wi | wf]; r (d, 3d) f32 is
    [rz | ri | rf]. Gates see h_{t-1} (true recurrence)."""
    zif = torch.addmm(gx, st.h, r)
    d = st.h.shape[-1]
    z = torch.tanh(zif[:, :d])
    i_f = torch.sigmoid(zif[:, d:])
    i, f = i_f[:, :d], i_f[:, d:]
    c = f * st.c + i * z
    n = f * st.n + i
    h = c / torch.clamp_min(n.abs(), 1.0)
    return SLSTMState(c=c, n=n, h=h)


def _slstm_out(p: Params, h: torch.Tensor) -> torch.Tensor:
    y = dense(p["wo"], h)
    return y + dense(p["ffn_dn"], _gelu(dense(p["ffn_up"], y)))


def slstm_block(p: Params, x: torch.Tensor, cfg: SLSTMConfig
                ) -> torch.Tensor:
    """Sequence form: a loop over time (O(S) sequential, inherent)."""
    B, S, d = x.shape
    gx = x.float() @ _gate_weights(p, SLSTM_GATES)        # (B,S,3d)
    r = _gate_weights(p, SLSTM_RECURRENT)
    st = slstm_init_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(gx[:, t], r, st)
        hs.append(st.h)
    return _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype))


def slstm_step(p: Params, x: torch.Tensor, state: SLSTMState,
               cfg: SLSTMConfig) -> Tuple[torch.Tensor, SLSTMState]:
    if shardctx.is_dtensor(state.h):
        return _slstm_step_on_mesh(p, x, state)
    gx = x[:, 0].float() @ _gate_weights(p, SLSTM_GATES)
    st2 = _slstm_cell(gx, _gate_weights(p, SLSTM_RECURRENT), state)
    return _slstm_out(p, st2.h[:, None].to(x.dtype)), st2


def _slstm_step_on_mesh(p: Params, x, state: SLSTMState
                        ) -> Tuple[torch.Tensor, SLSTMState]:
    """``slstm_step`` on a mesh, ``c``, ``n``, ``h`` split over tp on their
    feature dim (or whole). Each gate's two products are DTensor products
    in f32 (``shardctx.matmul``): the recurrent one takes h whole (its
    all-gather over tp, B_l x d f32) and gives the rank's feature slice;
    the cell's update is elementwise on the slice; c, n, h are written in
    place."""
    c, _, _, _ = shardctx.cache_local(state.c, "c", (1,))
    nn_, _, _, _ = shardctx.cache_local(state.n, "n", (1,))
    h, _, _, _ = shardctx.cache_local(state.h, "h", (1,))
    xf = x[:, 0].float()
    z, i, f = (shardctx.like_state(
        shardctx.matmul(xf, p[w]["w"].float())
        + shardctx.matmul(state.h, p[r]["w"].float()), state.h)
        for w, r in zip(SLSTM_GATES, SLSTM_RECURRENT))
    z, i, f = torch.tanh(z), torch.sigmoid(i), torch.sigmoid(f)
    c.copy_(f * c + i * z)
    nn_.copy_(f * nn_ + i)
    h.copy_(c / torch.clamp_min(nn_.abs(), 1.0))
    return _slstm_out(p, state.h[:, None].to(x.dtype)), state
