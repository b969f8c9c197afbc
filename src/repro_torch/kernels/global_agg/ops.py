"""Public wrapper of the global aggregation kernel (K4): checks, padding,
dispatch, launch.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
``csrc/global_agg.cu`` or raises. Padding is the JAX wrapper's: F is
zero-padded to a multiple of ``DEFAULT_BLOCK_F`` and, for 'mean', M to the
next power of two (zero rows leave the sum as it is; the divisor is the
padded M); the result is sliced back to F.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from .ref import global_agg_ref

DEFAULT_BLOCK_F = 128
IMPLS = ("mac", "extract_add")


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def global_agg(x: torch.Tensor, *, op: str = "sum",
               impl: str = "mac") -> torch.Tensor:
    """Sum/mean over the set dimension of an (M, F) int8 matrix -> (1, F).

    op: 'sum' -> int32; 'mean' -> int8 by the shift log2(Mp).
    impl: 'mac' (a dp4a against a constant ones word, the paper's MAC
    reduction) or 'extract_add' (serial sign-extended row adds, the
    baseline); both give the same bits.
    """
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if x.dim() != 2 or x.dtype != torch.int8:
        raise ValueError(f"x must be (M, F) int8, got {x.dtype} "
                         f"{tuple(x.shape)}")
    cpu = _build.on_cpu(x)
    m, f = x.shape
    fp = _round_up(f, DEFAULT_BLOCK_F)
    mp = 1 << (m - 1).bit_length() if op == "mean" else m
    xp = F.pad(x, (0, fp - f, 0, mp - m))
    out = global_agg_ref(xp, op=op) if cpu else _launch(xp, op, impl)
    return out[:, :f]


def _launch(x: torch.Tensor, op: str, impl: str) -> torch.Tensor:
    m, f = x.shape
    x = x.contiguous()
    if x.data_ptr() % 4:            # the mac kernel reads int8x4 words
        x = x.clone()
    mean = op == "mean"
    out = torch.empty((1, f), dtype=torch.int8 if mean else torch.int32,
                      device=x.device)
    if f == 0:
        return out
    lib = _build.library()
    code = lib.global_agg_launch(
        x.data_ptr(), out.data_ptr(), m, f,
        m.bit_length() - 1 if mean else 0, int(mean), IMPLS.index(impl),
        _build.stream_of(x))
    name = f"global_agg_{impl}"
    _build.check(code, name)
    _build.launches.add(name)
    return out
