"""Public wrapper of the INT8 MM kernel (K1): checks, dispatch, launch.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
``csrc/mm_int8.cu`` or raises. The kernel masks ragged M/N/K edges itself, so
the wrapper pads nothing (the JAX wrapper's zero padding is exact and only
the output has to match).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from .ref import mm_int8_ref

MAX_SHIFT = 30
_MAX_GRID_Y = 65535
_BLOCK = 32                     # rows a block carries (BM)


def mm_int8(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *, shift: int = 0,
            relu: bool = False, out_int8: bool = True) -> torch.Tensor:
    """INT8 dense layer y = requant(relu(x @ w + b)); arbitrary shapes.

    x: (M, K) int8, w: (K, N) int8, bias: (N,) or (1, N) int32. Returns
    (M, N) int8, or the raw int32 accumulator when ``out_int8=False``.
    """
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    n = w.shape[1]
    if bias is not None:
        if bias.dtype != torch.int32 or bias.numel() != n:
            raise ValueError(f"bias must be int32 with {n} entries")
        bias = bias.reshape(n)
    if not 0 <= shift <= MAX_SHIFT:
        raise ValueError(f"shift must be in 0..{MAX_SHIFT}, got {shift}")
    tensors = (x, w) if bias is None else (x, w, bias)
    if _build.on_cpu(*tensors):
        return mm_int8_ref(x, w, bias, shift=shift, relu=relu,
                           out_int8=out_int8)
    return _launch(x, w, bias, shift=shift, relu=relu, out_int8=out_int8)


def _launch(x, w, bias, *, shift, relu, out_int8):
    _build.require_contiguous(x=x, w=w, **({} if bias is None
                                           else {"bias": bias}))
    m, k = x.shape
    n = w.shape[1]
    if -(-m // _BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.int8 if out_int8 else torch.int32,
                      device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library()
    code = lib.mm_int8_launch(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, k, n, shift, int(relu), int(out_int8),
        _build.stream_of(x))
    _build.check(code, "mm_int8")
    _build.launches.add("mm_int8")
    return out
