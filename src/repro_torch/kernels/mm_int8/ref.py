"""Plain PyTorch version of the INT8 MM (+bias+ReLU+requant) kernel.

``torch.mm`` on int8 returns int8 with the sum wrapped on the CPU and has no
int32 kernel on CUDA, so the product runs in float64, which is exact while
|acc| < 2^53 (any K below 2^39 here), then goes through int64 and wraps to
int32, as an int32 accumulator does past 2^31 (a straight float-to-int32
cast would saturate there instead). It runs on either device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant import requantize_shift


def int8_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for int8 x (M, K) and w (K, N) in int32, wrapping on overflow."""
    acc = x.to(torch.float64) @ w.to(torch.float64)
    return acc.to(torch.int64).to(torch.int32)


def mm_int8_ref(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, shift: int = 0,
                relu: bool = False, out_int8: bool = True) -> torch.Tensor:
    """y = requant(relu(x @ w + b)) with INT32 accumulation.

    x: (M, K) int8, w: (K, N) int8, bias: (N,) int32.
    """
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    acc = int8_product(x, w)
    if bias is not None:
        acc = acc + bias.to(torch.int32).reshape(1, -1)
    if relu:
        acc = acc.clamp_min(0)
    if not out_int8:
        return acc
    return requantize_shift(acc, shift)
