"""The optimizer stack: the JAX package's ``src/repro/optim/__init__.py``.

AdamW with decoupled weight decay, global-norm gradient clipping, and a
linear-warmup + cosine-decay schedule, over the port's trees (nested dicts
and lists of tensors, ``repro_torch._tree``). The states mirror the params.

As in the reference, the schedule and the bias corrections are computed in
f32 from an int32 step tensor (Python floats would compute them in
float64), the update computes in f32 whatever the storage dtypes, and the
moments are stored in ``moment_dtype``. One difference: ``update`` works in
place on the params and the moments (under ``torch.no_grad``), so that a
step needs no second copy of the model's state; the numbers are the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch._tree import leaves, tree_map

Params = Any
F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    #: Adam moment storage dtype; "bfloat16" halves the optimizer state
    #: (updates still compute in f32).
    moment_dtype: str = "float32"


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr, in f32."""
    step = step.to(F32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Params, moment_dtype=F32) -> AdamWState:
    """Zero moments of ``params``' shapes in ``moment_dtype``; step 0 (int32)
    on the device of the first leaf."""
    mdt = _dtype(moment_dtype)
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params))


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """Grads scaled in f32 by min(1, max_norm / norm), each cast back to its
    own dtype; and the norm before clipping."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Params, state: AdamWState,
           params: Params) -> Tuple[Params, AdamWState, dict]:
    """One AdamW step. Returns (params, state, metrics); the params' and
    the moments' tensors are updated in place and returned."""
    gnorm = global_norm(grads)
    scale = None if cfg.clip_norm is None else _clip_scale(gnorm,
                                                            cfg.clip_norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)
    mdt = _dtype(cfg.moment_dtype)
    flat = [leaves(t) for t in (params, grads, state.mu, state.nu)]
    if len({len(f) for f in flat}) != 1:
        raise ValueError("params, grads and moments differ in structure")
    for p, g, m, v in zip(*flat):
        if m.dtype != mdt or v.dtype != mdt:
            raise ValueError(f"moments in {m.dtype}, config {mdt}")
        gf = g.to(F32)
        if scale is not None:
            gf = (gf * scale).to(g.dtype).to(F32)
        # In f32, in place where the storage is f32 (each operation rounds
        # as the reference's expression does).
        mf, vf, pf = m.to(F32), v.to(F32), p.to(F32)
        mf.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        vf.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        delta = (mf / b1c).div_(torch.sqrt(vf / b2c).add_(cfg.eps))
        pf.sub_(delta.add_(cfg.weight_decay * pf).mul_(lr))
        for dst, src in ((m, mf), (v, vf), (p, pf)):
            if dst is not src:
                dst.copy_(src)
    return (params, AdamWState(step=step, mu=state.mu, nu=state.nu),
            {"lr": lr, "grad_norm": gnorm})


__all__ = ["AdamWConfig", "AdamWState", "schedule", "init", "global_norm",
           "clip_by_global_norm", "update"]
