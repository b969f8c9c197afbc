"""Gradient compression for the cross-pod all-reduce (int8 + error
feedback): the JAX package's ``src/repro/distributed/compression.py``.

At multi-pod scale the ``pod`` axis crosses the slow inter-pod links; the
per-step gradient all-reduce there is the one collective that cannot be
overlapped away. This module compresses it 4x:

  * per-tensor symmetric int8 quantization of the gradient (power-of-two
    scales — the scheme the paper uses for its INT8 datapath, reused here
    for a different purpose);
  * **error feedback** (Seide et al.): the quantization residual is carried
    to the next step, so compression noise is a delayed — not lost — signal;
  * the all-reduce itself runs on the quantized payload (summed in int32,
    exact); decompression follows.

``compressed_psum`` runs on a process group (a mesh axis's, e.g.
``mesh.get_group("pod")``) over each rank's local gradients, as the
reference's runs inside ``shard_map``: an all-reduce (MAX) of each leaf's
scale, so every rank quantizes to one grid, then an all-reduce (SUM) of the
int32-widened payload, then ``* s / n``. Like the reference's driver,
``launch.train`` does not call it.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch._tree import leaves, tree_map, unflatten

Params = Any
F32 = torch.float32


def init_error_state(params: Params) -> Params:
    """Residual carry, same structure as the gradients, in f32."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def _pow2_scale(x: torch.Tensor) -> torch.Tensor:
    amax = torch.max(torch.abs(x))
    # smallest power of two with amax / s <= 127 (f32, as the reference)
    e = torch.ceil(torch.log2(torch.clamp_min(amax, 1e-30) / 127.0))
    return torch.exp2(e)


def _quantize(gf: torch.Tensor, s: torch.Tensor):
    # torch.round rounds half to even, as jnp.round
    q = torch.clamp(torch.round(gf / s), -128, 127).to(torch.int8)
    return q, gf - q.to(F32) * s


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad, error) -> (q int8, scale f32 scalar, new_error)."""
    gf = g.to(F32) + err
    s = _pow2_scale(gf)
    q, new_err = _quantize(gf, s)
    return q, s, new_err


def decompress(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * s


def compressed_psum(grads: Params, err_state: Params, group=None
                    ) -> Tuple[Params, Params]:
    """All-reduce ``grads`` over ``group`` (default: the whole world) with
    int8 + error feedback. Scales are max-reduced first so every rank
    quantizes to a common grid (required for the int32 sum to be exact).
    Returns (mean gradients in each leaf's dtype, new error state). Every
    rank of the group must call it with the same tree."""
    n = dist.get_world_size(group)
    out, errs = [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        gf = g.to(F32) + e
        s = _pow2_scale(gf)
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        q, new_e = _quantize(gf, s)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
        out.append((tot.to(F32) * s / n).to(g.dtype))
        errs.append(new_e)
    return unflatten(grads, out), unflatten(err_state, errs)


__all__ = ["init_error_state", "compress", "decompress", "compressed_psum"]
