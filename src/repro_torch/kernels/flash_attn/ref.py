"""Plain PyTorch version of the flash attention kernel (K5)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (BH, S, d), k/v (BH, T, d) -> (BH, S, d) in q's dtype; f32 scores
    and softmax, with key t visible to query s where t <= s when causal.

    The (BH, S, T) score matrix is materialized, and updated in place to
    hold one such matrix at a time.
    """
    s_len, d = q.shape[1], q.shape[2]
    t_len = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(s_len, device=q.device)[:, None]
        kpos = torch.arange(t_len, device=q.device)[None, :]
        s.masked_fill_(kpos > qpos, NEG_INF)
    w = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    w = w.div_(w.sum(dim=-1, keepdim=True))
    return torch.einsum("bst,btd->bsd", w, v.float()).to(q.dtype)
