"""Attention variants: the JAX package's ``src/repro/models/attention.py``.

One parameterized implementation covers MHA/GQA (n_kv <= n_heads), optional
QKV bias (qwen1.5), optional qk-norm (qwen3), a sliding window (mixtral),
RoPE / M-RoPE (qwen2-vl), and KV-cache decode with a bf16 or int8 cache (a
ring buffer for a window). MLA (minicpm3) is a separate path, as in the
reference. Every prefill runs through the hand-written flash attention
kernel (K5, ``kernels.flash_attn.flash_mha``) in bf16: causal with the
window, or without a mask (whisper's encoder, ``causal=False``); decode
attends over the cache in plain PyTorch, as the reference does outside any
Pallas kernel.

Shapes: x (B, S, d); q/k/v (B, S, H, hd); cache K/V (B, S_max, n_kv, hd).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attn import flash_mha
from .blocks import Params, apply_rope, dense, dense_init, rmsnorm, rmsnorm_init

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
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv, hd)
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
    q = q.reshape(B, S, kv, n_rep, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        logits = logits + m[:, None, None, :, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return out.reshape(B, S, H * hd)


def attention(p: Params, x: torch.Tensor, cfg: AttnConfig,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (prefill) attention.

    The reference's two causal branches (the dense ``_sdpa`` with
    ``_causal_mask(S, S, window)`` up to 4096 tokens and the chunked flash
    scan with the same window above) compute one function; here it is one
    call of K5 on q/k/v in bf16, with the window: a CUDA tensor launches the
    kernel, a CPU tensor takes its plain version. ``cfg.causal=False`` is
    the reference's dense ``_sdpa(q, k, v, None, n_rep)`` at any length
    (its window applies to the causal mask only, so it is ignored): one K5
    call with ``causal=False``. The output is cast back to x's dtype.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    bf16 = torch.bfloat16
    out = flash_mha(q.to(bf16), k.to(bf16), v.to(bf16), causal=cfg.causal,
                    window=cfg.window if cfg.causal else None).to(x.dtype)
    return dense(p["wo"], out)


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
    cache.k[:, slot] = _cache_store(k[:, 0], cache.k.dtype)
    cache.v[:, slot] = _cache_store(v[:, 0], cache.v.dtype)
    kpos = torch.arange(T, device=x.device)
    if cfg.window is not None:
        # ring buffer: valid entries are the last min(len+1, T) writes
        age = (slot - kpos) % T
        valid = age < min(length + 1, T)
    else:
        valid = kpos <= length
    mask = torch.where(valid, 0.0, NEG_INF)[None, None, :]    # (1,1,T)
    out = _sdpa(q, _cache_load(cache.k), _cache_load(cache.v),
                mask.expand(B, 1, T), cfg.n_heads // cfg.n_kv)
    y = dense(p["wo"], out)
    return y, KVCache(k=cache.k, v=cache.v, length=length + 1)


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64      #: per-head non-positional dim
    qk_rope_dim: int = 32      #: per-head decoupled-RoPE dim
    v_head_dim: int = 64
    rope_theta: float = 10000.0


def mla_init(gen, cfg: MLAConfig, dtype=torch.float32, device=None) -> Params:
    H = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora_rank, **kw),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, device=device),
        "wq_b": dense_init(gen, cfg.q_lora_rank, H * qk, **kw),
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
    q = dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x)))
    q = q.reshape(B, S, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], -1)
    return q_nope, apply_rope(q_rope, positions, theta=cfg.rope_theta)


def _mla_kv_a(p: Params, x: torch.Tensor, cfg: MLAConfig,
              positions: torch.Tensor):
    """The latent c_kv (B, S, r) and the shared rope key (B, S, 1, rope)."""
    kv_a = dense(p["wkv_a"], x)
    c_kv, k_rope = torch.split(kv_a, [cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        theta=cfg.rope_theta)
    return c_kv, k_rope


def _mla_kv_b(p: Params, c_kv: torch.Tensor, cfg: MLAConfig):
    """(k_nope, v) (B, T, H, ·) from the latent."""
    B, T, _ = c_kv.shape
    kv = dense(p["wkv_b"], rmsnorm(p["kv_norm"], c_kv))
    kv = kv.reshape(B, T, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    return torch.split(kv, [cfg.qk_nope_dim, cfg.v_head_dim], -1)


def mla_attention(p: Params, x: torch.Tensor, cfg: MLAConfig,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (prefill) MLA. The KV latent c_kv (rank kv_lora_rank)
    plus a shared rope key is all that decode needs to cache.

    The reference's score is q_nope . k_nope + q_rope . k_rope, scaled by
    1/sqrt(qk_nope + qk_rope), in its dense branch and its chunked flash
    scan alike (:357-411). That is one dot product over the concatenated
    width, so the prefill is one K5 bf16 call, causal, on
    q = [q_nope | q_rope] and k = [k_nope | k_rope broadcast over the heads]
    (qk_nope + qk_rope wide), with v zero-padded to that width (the padded
    columns of the output are exact zeros, and are sliced off).
    """
    B, S, _ = x.shape
    H = cfg.n_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_kv_a(p, x, cfg, positions)
    k_nope, v = _mla_kv_b(p, c_kv, cfg)
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    bf16 = torch.bfloat16
    q = torch.cat([q_nope, q_rope], dim=-1).to(bf16)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_dim)],
                  dim=-1).to(bf16)
    vd = cfg.v_head_dim
    vp = torch.nn.functional.pad(v, (0, qk - vd)) if qk > vd else v
    out = flash_mha(q, k, vp.to(bf16), scale=1.0 / math.sqrt(qk))
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
    cache.c_kv[:, slot] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, slot] = kr_new[:, 0, 0].to(cache.k_rope.dtype)
    k_nope, v = _mla_kv_b(p, cache.c_kv, cfg)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    logits = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             cache.k_rope.float())) * scale
    valid = torch.arange(T, device=x.device) <= length
    logits = logits + torch.where(valid, 0.0, NEG_INF)[None, None, None, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, v).reshape(B, 1, -1)
    return dense(p["wo"], out), MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope,
                                         length=length + 1)
