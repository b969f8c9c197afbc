"""Public wrappers of the flash attention kernel (K5): checks, layout,
dispatch, launch.

``flash_attention`` takes (BH, S, d) tensors; a CPU tensor goes to the plain
version in ``ref.py``, a CUDA tensor launches ``csrc/flash_attn.cu`` or
raises. ``flash_mha`` is the JAX package's GQA wrapper: it repeats the KV
heads, collapses batch and heads, pads S to the block grid and slices back.
Unlike the JAX wrapper, which exposes the causal mask only, it also takes
``causal=False`` with T != S (whisper's encoder and cross attention): the
reference computes those in its dense ``_sdpa`` with no mask.

Both take an optional ``window`` on the causal mask, the reference's
sliding window (``src/repro/models/attention.py:116-123``, and its chunked
flash scan at :181-183): key t is visible to query s where
s - window < t <= s. The JAX kernel has no window; the reference computes
windowed attention with the same flash schedule at the XLA level, and K5
runs it, skipping the key tiles below the window.

``block_q`` and ``block_k`` are the JAX kernel's tile sizes. They are kept
for its divisibility checks, which the callers pad for; the CUDA kernel
chooses its own tiles for the card and masks any ragged edge itself.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from .ref import check_window, flash_attention_ref

MAX_HEAD_DIM = 256              # the widest tile csrc/flash_attn.cu has
DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
# Query rows a block carries (F32Tiles<HD>::BQ and kTcBlockQ in
# csrc/flash_attn.cu): f32 128 up to d = 128 and 64 above; bf16 128.
_BLOCK_Q = {torch.float32: (128, 64), torch.bfloat16: (128, 128)}
# Both kernels copy 16-byte granules: d is padded to a multiple of this.
_D_ALIGN = {torch.float32: 4, torch.bfloat16: 8}


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (BH, S, d), k/v (BH, T, d), f32 or bf16 -> (BH, S, d) in q's dtype.
    S % block_q == 0 and T % block_k == 0 (``flash_mha`` pads). ``window``
    (causal only): query s sees keys s - window < t <= s."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q (BH, S, d), k and v (BH, T, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    t = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of {DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if s % block_q or t % block_k:
        raise ValueError(f"S={s} must be a multiple of block_q={block_q} and "
                         f"T={t} of block_k={block_k}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    check_window(window, causal)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if _build.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   window=window)
    return _launch(q, k, v, causal, scale, window)


def _launch(q, k, v, causal, scale, window):
    _build.require_contiguous(q=q, k=k, v=v)
    bh, s, d = q.shape
    if -(-s // _BLOCK_Q[q.dtype][d > 128]) > _MAX_GRID_Y:
        raise ValueError(f"S={s} exceeds the kernel's grid")
    if bh == 0 or s == 0:
        return torch.empty_like(q)
    # Both kernels load 16-byte granules (cp.async for f32, TMA for bf16),
    # which need rows a multiple of 16 bytes apart and 16-byte aligned
    # bases: pad d with zero columns (they add exact zeros to the scores)
    # and copy a misaligned view.
    dp = _round_up(d, _D_ALIGN[q.dtype])
    if dp != d:
        q, k, v = (F.pad(x, (0, dp - d)) for x in (q, k, v))
    else:
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
    out = torch.empty_like(q)
    # A window of S keys or more hides nothing (query s < S sees t > s - S
    # for every t >= 0); it goes to the kernel as S so that it fits an int.
    win = 0 if window is None else min(window, s)
    lib = _build.library()
    code = lib.flash_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
        k.shape[1], q.shape[2], int(causal), win, scale,
        int(q.dtype == torch.bfloat16),
        _build.stream_of(q))
    _build.check(code, "flash_attn")
    _build.launches.add("flash_attn")
    return out if out.shape[2] == d else out[..., :d].contiguous()


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, block_q: int = 128, block_k: int = 128,
              scale: Optional[float] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """GQA flash attention. q (B, S, H, hd); k/v (B, T, KV, hd), T == S when
    causal (the mask is t <= s, which the reference's ``_causal_mask(S, T)``
    equals only at T == S). Returns (B, S, H*hd). ``scale`` defaults to
    1/sqrt(hd); ``window`` (causal only): query s sees keys
    s - window < t <= s.

    Causal, q, k and v are padded to the block grid: a padded key lies
    above every real query, so the mask hides it. Without the mask a padded
    key would be visible (a zero key scores 0 and dilutes the softmax), so
    a non-causal call pads only q and hands the kernel the true T, whose
    ragged last key tile it masks itself (T goes to the divisibility check
    as one block)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, S, H, hd), k and v (B, T, KV, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != hd or kv == 0 or h % kv
            or (causal and t != s) or (not causal and t == 0)):
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}"
                         f" (causal={causal})")
    check_window(window, causal)
    n_rep = h // kv
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    # (B, S, H, hd) -> (B*H, S, hd)
    qf, kf, vf = (x.transpose(1, 2).reshape(b * h, x.shape[1], hd)
                  for x in (q, k, v))
    if causal:
        sp = _round_up(s, max(block_q, block_k))
        if sp != s:
            qf, kf, vf = (F.pad(x, (0, 0, 0, sp - s)) for x in (qf, kf, vf))
    else:
        sp = _round_up(s, block_q)
        if sp != s:
            qf = F.pad(qf, (0, 0, 0, sp - s))
        block_k = t
    out = flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                          causal=causal, block_q=block_q, block_k=block_k,
                          scale=scale, window=window)
    out = out[:, :s]
    return out.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)
