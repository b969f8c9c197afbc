"""Attention variants: the JAX package's ``src/repro/models/attention.py``.

One parameterized implementation covers MHA/GQA (n_kv <= n_heads), optional
QKV bias (qwen1.5), optional qk-norm (qwen3), a sliding window (mixtral),
RoPE / M-RoPE (qwen2-vl), and KV-cache decode with a bf16 or int8 cache (a
ring buffer for a window). MLA (minicpm3; DeepSeek-V2, outside the JAX
package's zoo: no query LoRA, YaRN) is a separate path, as in the
reference.

A prefill that needs no gradient runs through the hand-written flash
attention kernel (K5, ``kernels.flash_attn.flash_mha``) in bf16: causal
with the window, or without a mask (whisper's encoder, ``causal=False``).
Where grad mode is on and q, k or v requires grad (training), attention
runs the reference's own functions under autograd instead, as the
reference differentiates them (K5 has no backward, in the reference or
here, and refuses such inputs): the dense ``_sdpa`` with ``_causal_mask``
up to DENSE_ATTN_MAX_SEQ tokens, the chunked online-softmax
``_sdpa_q_chunked`` above, and MLA's dense and chunked branches, each at
the same lengths as the reference. Decode attends over the cache in plain
PyTorch, as the reference does outside any Pallas kernel.

On a mesh (DTensor activations under ``shardctx.sharding_hints``) the
reference's hints stand where it puts them: sequence-parallel q with
replicated k/v on the dense branch, heads over tp on the chunked one. K5
runs on each rank's heads and batch rows (``flash``); its causal mask needs
the whole sequence, so q is never sequence-sharded there. Decode over a
cache whose leaves are DTensors (``planner.cache_sharding``: the sequence
split over tp) is the distributed flash-decode of ``shardctx.seq_decode``:
the owner of the slot writes it, each rank attends over its own keys in
f32, a chunk at a time (``online_softmax``), and the partials combine
over tp.

Shapes: x (B, S, d); q/k/v (B, S, H, hd); cache K/V (B, S_max, n_kv, hd).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.yarn import YaRN, yarn_mscale
from repro_torch.distributed import shardctx
from repro_torch.kernels._build import spans
from repro_torch.kernels.flash_attn import flash_mha
from .blocks import (Params, apply_rope, dense, dense_init, rmsnorm,
                     rmsnorm_init, rope_freqs)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None       #: sliding/local attention window
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    causal: bool = True
    use_rope: bool = True              #: False for learned-pos models (whisper)
    #: "bfloat16" or "int8" — int8 halves KV-cache HBM again using the
    #: paper's symmetric power-of-two scheme (write: scaled round+clip;
    #: read: shift-dequant).
    cache_dtype: str = "bfloat16"


#: power-of-two KV quantization scale 2^e (paper §4.3.2 scheme): post-norm
#: k/v values sit in ~N(0, 1), so e = -3 spans ±15.9 at int8 resolution.
KV_SCALE_EXP = -3


def _cache_store(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int8:
        # torch.round rounds half to even, as the reference's jnp.round.
        return torch.clamp(torch.round(x.float() * 2.0 ** -KV_SCALE_EXP),
                           -128, 127).to(torch.int8)
    return x.to(dtype)


def _cache_load(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        # bf16 times a power of two: exact, in bf16 as the reference.
        return x.to(torch.bfloat16) * 2.0 ** KV_SCALE_EXP
    return x


def attn_init(gen, cfg: AttnConfig, dtype=torch.float32,
              device=None) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, d, cfg.n_kv * hd, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(gen, d, cfg.n_kv * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(hd, device=device)
        p["knorm"] = rmsnorm_init(hd, device=device)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: AttnConfig,
         positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    if cfg.mrope_sections is not None and positions.dim() == 2:
        # text-only M-RoPE: all three position streams coincide
        positions = torch.stack([positions] * 3, dim=-1)
    q = shardctx.unflatten(dense(p["wq"], x), 2, (cfg.n_heads, hd))
    k = shardctx.unflatten(dense(p["wk"], x), 2, (cfg.n_kv, hd))
    v = shardctx.unflatten(dense(p["wv"], x), 2, (cfg.n_kv, hd))
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q)
        k = rmsnorm(p["knorm"], k)
    if cfg.use_rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta,
                       mrope_sections=cfg.mrope_sections)
        k = apply_rope(k, positions, theta=cfg.rope_theta,
                       mrope_sections=cfg.mrope_sections)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep: int) -> torch.Tensor:
    """Grouped scaled-dot-product attention. q (B,S,H,hd), k/v (B,T,kv,hd),
    mask (S, T) or (B, S, T) additive. f32 scores and softmax; the weights
    are cast to v's dtype before the second product, as the reference."""
    B, S, H, hd = q.shape
    kv = k.shape[2]
    q = shardctx.unflatten(q, 2, (kv, n_rep))
    logits = torch.einsum("bsgrd,btgd->bgrst", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        logits = logits + m[:, None, None, :, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return out.reshape(B, S, H * hd)


def _causal_mask(S: int, T: int, window: Optional[int],
                 device=None) -> torch.Tensor:
    """Additive (S, T) f32 mask; queries at absolute positions T-S..T-1."""
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF)


#: Above this sequence length the reference replaces the dense (S x S)
#: score matrix by a scan over query chunks; training takes the same
#: branch at the same length.
DENSE_ATTN_MAX_SEQ = 4096


def _auto_q_chunk(S: int) -> int:
    """The reference's query-chunk size for the chunked path."""
    c = 512
    while S % c:
        c //= 2
    return max(c, 1)


def _sdpa_q_chunked(q, k, v, window: Optional[int], n_rep: int,
                    q_chunk: int, kv_chunk: int = 2048) -> torch.Tensor:
    """The reference's flash schedule at the framework level: loops over
    query and kv chunks with online-softmax statistics carried across kv
    steps, f32 scores and accumulators, every tile visited (as the
    reference's nested scans). q (B,S,H,hd), k/v (B,T,kv,hd) ->
    (B,S,H*hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, kvh = k.shape[1], k.shape[2]
    while T % kv_chunk:
        kv_chunk //= 2
    nq, nk = S // q_chunk, T // kv_chunk
    scale = 1.0 / math.sqrt(hd)
    qc = q.reshape(B, nq, q_chunk, kvh, n_rep, hd)
    kc = k.reshape(B, nk, kv_chunk, kvh, hd)
    vc = v.reshape(B, nk, kv_chunk, kvh, hd)
    ar_q = torch.arange(q_chunk, device=q.device)[:, None]
    ar_k = torch.arange(kv_chunk, device=q.device)[None, :]
    outs = []
    for i in range(nq):
        qi = qc[:, i].float()                          # (B,Cq,g,r,hd)
        qpos = i * q_chunk + ar_q
        stat = (B, kvh, n_rep, q_chunk)
        m = torch.full(stat, NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(stat, dtype=torch.float32, device=q.device)
        acc = torch.zeros((*stat, hd), dtype=torch.float32, device=q.device)
        for j in range(nk):
            s = torch.einsum("bqgrd,bkgd->bgrqk", qi,
                             kc[:, j].float()) * scale
            kpos = j * kv_chunk + ar_k
            ok = kpos <= qpos
            if window is not None:
                ok &= kpos > qpos - window
            s = torch.where(ok, s, NEG_INF)
            m2 = torch.maximum(m, s.amax(dim=-1))
            # masked tiles: exp(s - m2) would be exp(0) on all-NEG_INF rows
            pr = torch.where(ok, torch.exp(s - m2[..., None]), 0.0)
            corr = torch.exp(m - m2)
            l = corr * l + pr.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bgrqk,bkgd->bgrqd", pr, vc[:, j].float()))
            m = m2
        out = acc / torch.clamp_min(l, 1e-30)[..., None]   # (B,g,r,Cq,hd)
        out = out.permute(0, 3, 1, 2, 4).to(q.dtype)
        outs.append(out.reshape(B, q_chunk, H * hd))
    return torch.cat(outs, dim=1)


def flash(q, k, v, **kw) -> torch.Tensor:
    """``flash_mha`` (K5); on DTensors, on each rank's heads and batch rows
    (``shardctx.heads_local``: the kernel takes raw pointers)."""
    if shardctx.is_dtensor(q):
        return shardctx.heads_local(flash_mha, q, k, v, **kw)
    return flash_mha(q, k, v, **kw)


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd must see through an attention on ``ts``: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def attention(p: Params, x: torch.Tensor, cfg: AttnConfig,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (training/prefill) attention.

    Without a gradient to carry, the reference's two causal branches (the
    dense ``_sdpa`` with ``_causal_mask(S, S, window)`` up to 4096 tokens
    and the chunked flash scan with the same window above) compute one
    function: one call of K5 on q/k/v in bf16, with the window (a CUDA
    tensor launches the kernel, a CPU tensor takes its plain version).
    ``cfg.causal=False`` is the reference's dense ``_sdpa(q, k, v, None,
    n_rep)`` at any length (its window applies to the causal mask only, so
    it is ignored): one K5 call with ``causal=False``. The output is cast
    back to x's dtype. With a gradient to carry (``needs_grad``), the
    reference's own branch runs under autograd.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv
    if not needs_grad(q, k, v):
        bf16 = torch.bfloat16
        out = flash(q.to(bf16), k.to(bf16), v.to(bf16), causal=cfg.causal,
                    window=cfg.window if cfg.causal else None).to(x.dtype)
    elif cfg.causal and S > DENSE_ATTN_MAX_SEQ:
        # long prefill: memory-bounded q-chunk loop; heads TP-sharded
        q, k, v = (shardctx.constrain_heads(t) for t in (q, k, v))
        out = _sdpa_q_chunked(q, k, v, cfg.window, n_rep, _auto_q_chunk(S))
    else:
        # dense path: sequence-parallel attention (scores q-seq-sharded)
        mask = (_causal_mask(S, S, cfg.window, x.device) if cfg.causal
                else None)
        out = dense_sdpa(q, k, v, mask, n_rep)
    return dense(p["wo"], out)


def dense_sdpa(q, k, v, mask, n_rep: int) -> torch.Tensor:
    """``_sdpa`` with the reference's sequence-parallel hints: on DTensors
    each rank's query rows (and their rows of the (S, T) mask) against the
    whole k/v (``shardctx.seq_local``)."""
    if not shardctx.is_dtensor(q):
        return _sdpa(q, k, v, mask, n_rep)

    def local(ql, kl, vl, q0):
        m = None if mask is None else mask[q0:q0 + ql.shape[1]]
        return _sdpa(ql, kl, vl, m, n_rep)

    return shardctx.seq_local(local, (q,), (k, v))


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, n_kv, hd)
    v: torch.Tensor
    length: int       # tokens written so far


def init_cache(cfg: AttnConfig, batch: int, max_len: int, dtype=None,
               device=None) -> KVCache:
    if dtype is None:
        dtype = torch.int8 if cfg.cache_dtype == "int8" else torch.bfloat16
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def decode_step(p: Params, x: torch.Tensor, cache: KVCache, cfg: AttnConfig,
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d). For sliding-window configs the cache
    is a ring buffer of size window (positions wrap), so a long context
    costs O(window) memory.

    The new K/V are written into the cache tensors in place (the reference
    returns new arrays); the returned cache holds the same tensors with
    ``length + 1``.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode_step takes one token; got S={S}")
    T = cache.k.shape[1]
    length = cache.length
    pos = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos)
    # The reference's dynamic_update_slice clamps a start past the end.
    slot = (length % T) if cfg.window is not None else min(length, T - 1)
    if shardctx.is_dtensor(cache.k):
        out = _decode_on_mesh(q, k, v, cache, cfg, slot)
        return dense(p["wo"], out), cache._replace(length=length + 1)
    cache.k[:, slot] = _cache_store(k[:, 0], cache.k.dtype)
    cache.v[:, slot] = _cache_store(v[:, 0], cache.v.dtype)
    valid = _valid(torch.arange(T, device=x.device), slot, length, T,
                   cfg.window)
    mask = torch.where(valid, 0.0, NEG_INF)[None, None, :]    # (1,1,T)
    out = _sdpa(q, _cache_load(cache.k), _cache_load(cache.v),
                mask.expand(B, 1, T), cfg.n_heads // cfg.n_kv)
    y = dense(p["wo"], out)
    return y, KVCache(k=cache.k, v=cache.v, length=length + 1)


def _valid(kpos: torch.Tensor, slot: int, length: int, T: int,
           window: Optional[int]) -> torch.Tensor:
    """Which cache entries at positions ``kpos`` the token after ``length``
    attends to, its own K/V written at ``slot``."""
    if window is not None:
        # ring buffer: valid entries are the last min(len+1, T) writes
        age = (slot - kpos) % T
        return age < min(length + 1, T)
    return kpos <= length


#: Keys a chunk in the mesh decode's online softmax: its f32 transients
#: are a chunk of the rank's cache shard, never the shard.
DECODE_KV_CHUNK = 1024


def online_softmax(score, mix, valid: torch.Tensor,
                   chunk: int = DECODE_KV_CHUNK):
    """(m, l, o) in f32 of one query a head over the keys ``valid`` marks,
    a chunk of keys at a time: ``score(sl) -> (s (B, X, C), ctx)`` gives
    the scaled scores of keys ``sl`` and ``mix(p, ctx) -> (B, X, D)`` the
    product of their weights with their values. m is the running max
    (NEG_INF where no key is valid yet, and then l and o are 0), l the sum
    of exp(s - m), o the weighted sum of values, as ``_sdpa_q_chunked``
    carries them."""
    m = l = o = None
    n = valid.shape[0]
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        s, ctx = score(sl)
        ok = valid[sl]
        s = torch.where(ok, s, NEG_INF)
        m2 = s.amax(dim=-1) if m is None else torch.maximum(m, s.amax(dim=-1))
        pr = torch.where(ok, torch.exp(s - m2[..., None]), 0.0)
        pv = mix(pr, ctx)
        if m is None:
            l, o = pr.sum(dim=-1), pv
        else:
            corr = torch.exp(m - m2)
            l = corr * l + pr.sum(dim=-1)
            o = o * corr[..., None] + pv
        m = m2
    return m, l, o


def _decode_on_mesh(q, k, v, cache: KVCache, cfg: AttnConfig,
                    slot: int) -> torch.Tensor:
    """Decode attention over a cache on a mesh: the distributed
    flash-decode of ``shardctx.seq_decode`` (the cache's sequence dim
    split over tp), each rank's partial in f32 over its keys, in chunks.
    Returns (B, 1, H*hd) in the cache's loaded dtype, on the rows."""
    B, H, KV, hd = q.shape[0], cfg.n_heads, cfg.n_kv, cfg.head_dim
    rep, T, length = H // KV, cache.k.shape[1], cache.length

    def partial(ql, cl, kpos, _):
        (qq,), (ck, cv) = ql, cl
        b = qq.shape[0]
        qg = qq[:, 0].float().reshape(b, KV, rep, hd)

        def score(sl):
            kk = _cache_load(ck[:, sl]).float()
            s = torch.einsum("bgrd,btgd->bgrt", qg, kk) / math.sqrt(hd)
            return s.reshape(b, H, -1), sl

        def mix(pr, sl):
            vv = _cache_load(cv[:, sl]).float()
            o = torch.einsum("bgrt,btgd->bgrd", pr.reshape(b, KV, rep, -1),
                             vv)
            return o.reshape(b, H, hd)

        return online_softmax(score, mix,
                              _valid(kpos, slot, length, T, cfg.window))

    out = shardctx.seq_decode(
        partial, (q,), {"k": cache.k, "v": cache.v},
        {"k": _cache_store(k, cache.k.dtype),
         "v": _cache_store(v, cache.v.dtype)}, slot)
    dtype = torch.bfloat16 if cache.v.dtype == torch.int8 else cache.v.dtype
    return out.reshape(B, 1, H * hd).to(dtype)


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """MiniCPM3's MLA by default; DeepSeek-V2's with ``q_lora_rank=None``
    (q = x·wq, no ``wq_a``/``q_norm``), ``yarn`` (YaRN's frequencies for the
    rope columns, and its mscale² on the softmax scale) and
    ``rope_interleaved`` (the published pairing: rope rotates columns
    (2i, 2i+1) of a head's rope part, where ``blocks.apply_rope`` rotates
    (i, i + rope/2); the rotated pairs come out in the half-split layout,
    in q and k alike, so the scores are the published ones)."""
    d_model: int
    n_heads: int
    q_lora_rank: Optional[int] = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64      #: per-head non-positional dim
    qk_rope_dim: int = 32      #: per-head decoupled-RoPE dim
    v_head_dim: int = 64
    rope_theta: float = 10000.0
    yarn: Optional[YaRN] = None
    rope_interleaved: bool = False


def mla_scale(cfg: MLAConfig) -> float:
    """The softmax scale: 1/sqrt(qk_nope + qk_rope), times YaRN's
    ``yarn_mscale(factor, mscale_all_dim)`` squared where it applies (the
    published ``softmax_scale``)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    y = cfg.yarn
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def yarn_freqs(dim: int, theta: float, y: YaRN) -> torch.Tensor:
    """YaRN's inverse frequencies (dim/2,) f32, as the published
    ``DeepseekV2YarnRotaryEmbedding``: index i keeps theta^(-2i/dim) below
    the correction range [low, high] that ``beta_fast`` and ``beta_slow``
    rotations over ``original_max_position`` give, takes it ÷ ``factor``
    above it, and follows the linear ramp (i - low)/(high - low) between."""
    def corr(rotations):
        return (dim * math.log(y.original_max_position
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(y.beta_fast)), 0)
    high = min(math.ceil(corr(y.beta_slow)), dim - 1)
    extra = rope_freqs(dim, theta)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    return extra / y.factor * ramp + extra * (1 - ramp)


@functools.lru_cache(maxsize=None)
def _mla_rope_table(cfg: MLAConfig, device: torch.device):
    """(inverse frequencies, cos/sin factor) of the config on ``device``:
    computed once a config and device."""
    y = cfg.yarn
    if y is None:
        return rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, device), 1.0
    return (yarn_freqs(cfg.qk_rope_dim, cfg.rope_theta, y).to(device),
            yarn_mscale(y.factor, y.mscale)
            / yarn_mscale(y.factor, y.mscale_all_dim))


def mla_rope(x: torch.Tensor, positions: torch.Tensor,
             cfg: MLAConfig) -> torch.Tensor:
    """The rope of MLA's rope columns x (B, S, H, rope) at positions
    (B, S): ``blocks.apply_rope`` without YaRN; with it, YaRN's frequencies
    and cos/sin factor, and the published pairing where
    ``rope_interleaved``."""
    if cfg.yarn is None and not cfg.rope_interleaved:
        return apply_rope(x, positions, theta=cfg.rope_theta)
    freqs, m = _mla_rope_table(cfg, x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    if m != 1.0:
        cos, sin = cos * m, sin * m
    xf = x.float()
    if cfg.rope_interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
    else:
        x1, x2 = torch.chunk(xf, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def mla_init(gen, cfg: MLAConfig, dtype=torch.float32, device=None) -> Params:
    H = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    kw = dict(dtype=dtype, device=device)
    if cfg.q_lora_rank is None:
        q = {"wq": dense_init(gen, cfg.d_model, H * qk, **kw)}
    else:
        q = {"wq_a": dense_init(gen, cfg.d_model, cfg.q_lora_rank, **kw),
             "q_norm": rmsnorm_init(cfg.q_lora_rank, device=device),
             "wq_b": dense_init(gen, cfg.q_lora_rank, H * qk, **kw)}
    return {
        **q,
        "wkv_a": dense_init(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_dim, **kw),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, device=device),
        "wkv_b": dense_init(gen, cfg.kv_lora_rank,
                            H * (cfg.qk_nope_dim + cfg.v_head_dim), **kw),
        "wo": dense_init(gen, H * cfg.v_head_dim, cfg.d_model, **kw),
    }


def _mla_q(p: Params, x: torch.Tensor, cfg: MLAConfig,
           positions: torch.Tensor):
    """(q_nope, q_rope) (B, S, H, ·), RoPE applied to q_rope."""
    B, S, _ = x.shape
    q = (dense(p["wq"], x) if cfg.q_lora_rank is None else
         dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x))))
    q = shardctx.unflatten(q, 2, (cfg.n_heads,
                                  cfg.qk_nope_dim + cfg.qk_rope_dim))
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], -1)
    return q_nope, mla_rope(q_rope, positions, cfg)


def _mla_kv_a(p: Params, x: torch.Tensor, cfg: MLAConfig,
              positions: torch.Tensor):
    """The latent c_kv (B, S, r) and the shared rope key (B, S, 1, rope)."""
    kv_a = dense(p["wkv_a"], x)
    c_kv, k_rope = torch.split(kv_a, [cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
    return c_kv, mla_rope(k_rope[:, :, None, :], positions, cfg)


def _mla_kv_b(p: Params, c_kv: torch.Tensor, cfg: MLAConfig):
    """(k_nope, v) (B, T, H, ·) from the latent."""
    B, T, _ = c_kv.shape
    kv = dense(p["wkv_b"], rmsnorm(p["kv_norm"], c_kv))
    kv = shardctx.unflatten(kv, 2, (cfg.n_heads,
                                    cfg.qk_nope_dim + cfg.v_head_dim))
    return torch.split(kv, [cfg.qk_nope_dim, cfg.v_head_dim], -1)


def _mla_sdpa(q_nope, q_rope, k_nope, kr, v, scale: float,
              mask: torch.Tensor) -> torch.Tensor:
    """The reference's dense MLA score q_nope . k_nope + q_rope . k_rope
    (f32), softmax, weights cast to v's dtype. kr (B,T,1,rope) is the
    shared rope key. Returns (B,S,H,vd)."""
    logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshd,btxd->bhst", q_rope.float(), kr.float())
              ) * scale
    logits = logits + mask[None, None]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def _mla_sdpa_q_chunked(q_nope, q_rope, k_nope, kr, v, scale: float,
                        q_chunk: int, kv_chunk: int = 2048,
                        out_dtype=None) -> torch.Tensor:
    """The reference's chunked MLA branch: the two-part score formed a
    tile at a time, online softmax over kv chunks, every tile visited.
    Returns (B,S,H*vd) in ``out_dtype`` (the reference casts to x's)."""
    B, S, H, _ = q_nope.shape
    T, vd = k_nope.shape[1], v.shape[-1]
    while T % kv_chunk:
        kv_chunk //= 2
    nq, nk = S // q_chunk, T // kv_chunk
    dev = q_nope.device
    ar_q = torch.arange(q_chunk, device=dev)[:, None]
    ar_k = torch.arange(kv_chunk, device=dev)[None, :]
    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qn_i, qr_i = q_nope[:, qs].float(), q_rope[:, qs].float()
        qpos = i * q_chunk + ar_q
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, vd), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            s = (torch.einsum("bqhd,bkhd->bhqk", qn_i, k_nope[:, ks].float())
                 + torch.einsum("bqhd,bkxd->bhqk", qr_i, kr[:, ks].float())
                 ) * scale
            ok = j * kv_chunk + ar_k <= qpos
            s = torch.where(ok, s, NEG_INF)
            m2 = torch.maximum(m, s.amax(dim=-1))
            pr = torch.where(ok, torch.exp(s - m2[..., None]), 0.0)
            corr = torch.exp(m - m2)
            l = corr * l + pr.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bhqk,bkhd->bhqd", pr, v[:, ks].float()))
            m = m2
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        o = o.permute(0, 2, 1, 3).to(out_dtype or v.dtype)   # (B,Cq,H,vd)
        outs.append(o.reshape(B, q_chunk, H * vd))
    return torch.cat(outs, dim=1)


def mla_attention(p: Params, x: torch.Tensor, cfg: MLAConfig,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (training/prefill) MLA. The KV latent c_kv (rank
    kv_lora_rank) plus a shared rope key is all that decode needs to cache.

    The reference's score is q_nope . k_nope + q_rope . k_rope, scaled by
    1/sqrt(qk_nope + qk_rope) (``mla_scale``: with YaRN's mscale² for
    DeepSeek-V2), in its dense branch and its chunked flash scan alike
    (:357-411). That is one dot product over the concatenated
    width, so without a gradient to carry the prefill is one K5 bf16 call,
    causal, on q = [q_nope | q_rope] and k = [k_nope | k_rope broadcast
    over the heads] (qk_nope + qk_rope wide), with v zero-padded to that
    width (the padded columns of the output are exact zeros, and are
    sliced off). With a gradient to carry (``needs_grad``), the
    reference's dense or chunked branch runs under autograd. A profiler
    that records sees the call as span ``repro_torch.mla``.
    """
    span = spans.begin("repro_torch.mla")
    out = _mla_attention(p, x, cfg, positions)
    if span is not None:
        span.end()
    return out


def _mla_attention(p: Params, x: torch.Tensor, cfg: MLAConfig,
                   positions: Optional[torch.Tensor]) -> torch.Tensor:
    B, S, _ = x.shape
    H = cfg.n_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_kv_a(p, x, cfg, positions)
    k_nope, v = _mla_kv_b(p, c_kv, cfg)
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    scale = mla_scale(cfg)
    vd = cfg.v_head_dim
    if needs_grad(q_nope, q_rope, k_nope, k_rope, v):
        if S > DENSE_ATTN_MAX_SEQ:
            q_nope, q_rope, k_nope, v = (shardctx.constrain_heads(t) for t in
                                         (q_nope, q_rope, k_nope, v))
            out = _mla_sdpa_q_chunked(q_nope, q_rope, k_nope, k_rope, v,
                                      scale, _auto_q_chunk(S),
                                      out_dtype=x.dtype)
        else:
            mask = _causal_mask(S, S, None, x.device)

            def local(qn, qr, kn, kr, vv, q0):
                return _mla_sdpa(qn, qr, kn, kr, vv, scale,
                                 mask[q0:q0 + qn.shape[1]])

            out = (shardctx.seq_local(local, (q_nope, q_rope),
                                      (k_nope, k_rope, v))
                   if shardctx.is_dtensor(q_nope) else
                   local(q_nope, q_rope, k_nope, k_rope, v, 0)
                   ).reshape(B, S, H * vd)
        return dense(p["wo"], out)
    bf16 = torch.bfloat16
    q = torch.cat([q_nope, q_rope], dim=-1).to(bf16)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_dim)],
                  dim=-1).to(bf16)
    vp = torch.nn.functional.pad(v, (0, qk - vd)) if qk > vd else v
    out = flash(q, k, vp.to(bf16), scale=scale)
    out = out.reshape(B, S, H, qk)[..., :vd].to(x.dtype)
    return dense(p["wo"], out.reshape(B, S, H * vd))


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, S_max, kv_lora_rank)
    k_rope: torch.Tensor   # (B, S_max, qk_rope_dim)
    length: int            # tokens written so far


def mla_init_cache(cfg: MLAConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                           device=device),
        length=0)


def mla_decode_step(p: Params, x: torch.Tensor, cache: MLACache,
                    cfg: MLAConfig) -> Tuple[torch.Tensor, MLACache]:
    """One-token MLA decode from the latent cache, in plain PyTorch as the
    reference: ``wkv_b`` is applied to the whole latent cache every step.

    The new latent and rope key are written into the cache tensors in place
    (the reference returns new arrays); the returned cache holds the same
    tensors with ``length + 1``.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"mla_decode_step takes one token; got S={S}")
    T = cache.c_kv.shape[1]
    length = cache.length
    pos = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    c_new, kr_new = _mla_kv_a(p, x, cfg, pos)
    # The reference's dynamic_update_slice clamps a start past the end.
    slot = min(length, T - 1)
    if shardctx.is_dtensor(cache.c_kv):
        out = _mla_decode_on_mesh(p, q_nope, q_rope, c_new, kr_new, cache,
                                  cfg, slot)
        return dense(p["wo"], out), cache._replace(length=length + 1)
    cache.c_kv[:, slot] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, slot] = kr_new[:, 0, 0].to(cache.k_rope.dtype)
    k_nope, v = _mla_kv_b(p, cache.c_kv, cfg)
    scale = mla_scale(cfg)
    logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             cache.k_rope.float())) * scale
    valid = torch.arange(T, device=x.device) <= length
    logits = logits + torch.where(valid, 0.0, NEG_INF)[None, None, None, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, v).reshape(B, 1, -1)
    return dense(p["wo"], out), MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope,
                                         length=length + 1)


def _mla_decode_on_mesh(p: Params, q_nope, q_rope, c_new, kr_new,
                        cache: MLACache, cfg: MLAConfig, slot: int):
    """MLA decode over a latent cache on a mesh: ``shardctx.seq_decode``
    over ``c_kv`` and ``k_rope`` (their sequence dim split over tp), each
    rank applying ``kv_norm`` and ``wkv_b`` (gathered whole: r x H x
    (nope + v) weights) to its own latent rows, a chunk at a time, as the
    plain decode applies them to the whole cache. Returns (B, 1, H*vd) in
    the cache's dtype, on the rows."""
    B, H, vd = q_nope.shape[0], cfg.n_heads, cfg.v_head_dim
    scale = mla_scale(cfg)
    length = cache.length

    def partial(ql, cl, kpos, pp):
        (qn, qr), (ckv, ckr) = ql, cl
        qn, qr = qn[:, 0].float(), qr[:, 0].float()

        def score(sl):
            k_nope, v = _mla_kv_b(pp, ckv[:, sl], cfg)
            s = (torch.einsum("bhd,bthd->bht", qn, k_nope.float())
                 + torch.einsum("bhd,btd->bht", qr, ckr[:, sl].float())
                 ) * scale
            return s, v

        def mix(pr, v):
            return torch.einsum("bht,bthd->bhd", pr, v.float())

        return online_softmax(score, mix, kpos <= length)

    out = shardctx.seq_decode(
        partial, (q_nope, q_rope),
        {"c_kv": cache.c_kv, "k_rope": cache.k_rope},
        {"c_kv": c_new.to(cache.c_kv.dtype),
         "k_rope": kr_new[:, :, 0].to(cache.k_rope.dtype)}, slot,
        params={"kv_norm": p["kv_norm"], "wkv_b": p["wkv_b"]})
    return out.reshape(B, 1, H * vd).to(cache.c_kv.dtype)
