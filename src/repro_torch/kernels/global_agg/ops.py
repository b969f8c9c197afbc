"""Public wrapper of the global aggregation kernel (K4): checks, dispatch,
launch.

A CPU tensor goes to the plain version in ``ref.py`` the JAX wrapper's way:
F zero-padded to a multiple of ``DEFAULT_BLOCK_F`` and, for 'mean', M to the
next power of two (zero rows leave the sum as it is; the divisor is the
padded M), the result sliced back to F. A CUDA tensor launches
``csrc/global_agg.cu`` once on the (M, F) matrix as it stands, with no pad
and no copy: the kernel masks ragged columns, reads any row stride and any
alignment, and divides a 'mean' by the padded M's shift itself.
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

    op: 'sum' -> int32; 'mean' -> int8 by the shift log2(Mp), Mp being M
    rounded up to a power of two.
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
    m, f = x.shape
    mp = 1 << (m - 1).bit_length() if op == "mean" else m
    if _build.on_cpu(x):
        xp = F.pad(x, (0, _round_up(f, DEFAULT_BLOCK_F) - f, 0, mp - m))
        return global_agg_ref(xp, op=op)[:, :f]
    return _launch(x, op, impl, mp)


def _launch(x: torch.Tensor, op: str, impl: str, mp: int) -> torch.Tensor:
    """One launch on ``x`` as it stands; 'mean' shifts by log2(mp)."""
    m, f = x.shape
    if f > 1 and x.stride(1) != 1:   # the kernel reads unit column stride
        x = x.contiguous()
    mean = op == "mean"
    out = torch.empty((1, f), dtype=torch.int8 if mean else torch.int32,
                      device=x.device)
    if f == 0:
        return out
    lib = _build.library()
    code = lib.global_agg_launch(
        x.data_ptr(), out.data_ptr(), m, f, x.stride(0),
        mp.bit_length() - 1 if mean else 0, int(mean), IMPLS.index(impl),
        _build.stream_of(x))
    name = f"global_agg_{impl}"
    _build.check(code, name)
    _build.launches.add(name)
    return out
