"""Plain PyTorch version of the global aggregation kernel (K4)."""
from __future__ import annotations

import torch

from repro_torch.quant import requantize_shift


def global_agg_ref(x: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """Reduce the set axis (-2) of an (..., M, F) int8 tensor, keeping it.

    'sum'  -> (..., 1, F) int32
    'mean' -> (..., 1, F) int8 by the power-of-two shift log2(M), rounding
              half away from zero and saturating (M must be a power of two,
              the paper's DeepSets setting).
    """
    acc = x.to(torch.int32).sum(dim=-2, keepdim=True, dtype=torch.int32)
    if op == "sum":
        return acc
    if op != "mean":
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    m = x.shape[-2]
    if m & (m - 1):
        raise ValueError("mean reduction needs a power-of-two M")
    return requantize_shift(acc, m.bit_length() - 1)
