"""Common model blocks: norms, MLPs, embeddings, RoPE — plain functions on
tensors, and their init.

The JAX package's conventions (``src/repro/models/blocks.py``), kept:
  * params are nested dicts of tensors;
  * every forward is a plain function ``f(params, x)``;
  * computation dtype is bf16 with f32 for norms, softmax and logits.
One difference: the JAX package keeps f32 weights and casts them to the
activation dtype at every use; ``models.transformer`` holds the matmul
weights in bf16 on the device instead, which computes the same function in
half the memory. The init functions draw f32 one tensor at a time and cast
to ``dtype``, so that the peak is one tensor's f32 size. On a mesh the
products run in ``shardctx.matmul``'s layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import shardctx

Params = Dict[str, Any]


def _init(gen: torch.Generator, shape, scale: Optional[float] = None,
          dtype=torch.float32, device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def layernorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / MLP. Plain large products outside any TPU kernel: torch.matmul, as
# the JAX package leaves them to XLA.
# ---------------------------------------------------------------------------

def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, device=None) -> Params:
    p = {"w": _init(gen, (d_in, d_out), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = shardctx.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def swiglu_init(gen, d: int, d_ff: int, dtype=torch.float32,
                device=None) -> Params:
    return {"wg": _init(gen, (d, d_ff), dtype=dtype, device=device),
            "wu": _init(gen, (d, d_ff), dtype=dtype, device=device),
            "wd": _init(gen, (d_ff, d), dtype=dtype, device=device)}


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(shardctx.matmul(x, p["wg"].to(x.dtype)))
    u = shardctx.matmul(x, p["wu"].to(x.dtype))
    return shardctx.matmul(g * u, p["wd"].to(x.dtype))


def gelu_mlp_init(gen, d: int, d_ff: int, dtype=torch.float32,
                  device=None) -> Params:
    return {"wi": _init(gen, (d, d_ff), dtype=dtype, device=device),
            "wo": _init(gen, (d_ff, d), dtype=dtype, device=device),
            "bi": torch.zeros((d_ff,), dtype=dtype, device=device),
            "bo": torch.zeros((d,), dtype=dtype, device=device)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    # The reference's GELU is the tanh approximation (its default).
    h = F.gelu(shardctx.matmul(x, p["wi"].to(x.dtype)) + p["bi"].to(x.dtype),
               approximate="tanh")
    return shardctx.matmul(h, p["wo"].to(x.dtype)) + p["bo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab: int, d: int, dtype=torch.float32,
                   device=None) -> Params:
    return {"emb": _init(gen, (vocab, d), scale=1.0, dtype=dtype,
                         device=device)}


def embed(p: Params, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    return shardctx.embed(p["emb"].to(dtype), tokens)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in f32 for a stable softmax/loss."""
    return shardctx.matmul(x, p["emb"].to(x.dtype).T).float()


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE sections for qwen2-vl)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0,
               mrope_sections: Optional[Tuple[int, ...]] = None
               ) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D); positions: (B, S) or (B, S, 3)
    for M-RoPE (temporal/height/width sections, Qwen2-VL §2).
    """
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)      # (D/2,)
    if mrope_sections is None:
        ang = positions[..., None].float() * freqs     # (B,S,D/2)
    else:
        # split the D/2 frequency channels into 3 position streams
        if positions.dim() != 3 or positions.shape[-1] != 3:
            raise ValueError(f"M-RoPE takes positions (B, S, 3); got "
                             f"{tuple(positions.shape)}")
        secs = []
        start = 0
        for i, sec in enumerate(mrope_sections):
            f = freqs[start:start + sec]
            secs.append(positions[..., i:i + 1].float() * f)
            start += sec
        ang = torch.cat(secs, dim=-1)                  # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
