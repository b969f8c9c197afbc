"""Plain PyTorch version of the flash attention kernel (K5)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30

#: Query rows a block of the plain version takes at most: the reference
#: scan's query chunk (``_auto_q_chunk``, ``src/repro/models/attention.py:
#: 131-139``).
Q_BLOCK = 512


def check_window(window: Optional[int], causal: bool) -> None:
    """Raises ValueError for a window the mask cannot take."""
    if window is None:
        return
    if not causal:
        raise ValueError("a window applies to the causal mask only; got "
                         f"window={window} with causal=False")
    if window < 1:
        raise ValueError(f"window must be at least 1; got {window}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (BH, S, d), k/v (BH, T, d) -> (BH, S, d) in q's dtype; f32 scores
    and softmax, with key t visible to query s where t <= s when causal,
    and also t > s - window with a window (the reference's sliding-window
    mask, ``src/repro/models/attention.py:116-123``).

    A hidden key weighs exactly 0, as in the reference's chunked scan
    (``jnp.where(ok, exp(s - m), 0)``, :187), so a row that sees no key at
    all (a window with S > T + window) gives 0. The rows of q go in blocks
    of at most Q_BLOCK, each against all T keys with one softmax over the
    whole row, so the scores live at a time are one (BH, Q_BLOCK, T)
    block, updated in place, never (BH, S, T); every (s, t) pair is
    computed, as the reference's scan computes every tile.
    """
    check_window(window, causal)
    s_len, d = q.shape[1], q.shape[2]
    t_len = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kt, vf = k.float().transpose(1, 2), v.float()
    kpos = torch.arange(t_len, device=q.device)[None, :]
    out = q.new_empty(q.shape)
    for i in range(0, s_len, Q_BLOCK):
        j = min(i + Q_BLOCK, s_len)
        s = torch.bmm(q[:, i:j].float(), kt).mul_(scale)
        hidden = None
        if causal:
            qpos = torch.arange(i, j, device=q.device)[:, None]
            hidden = kpos > qpos
            if window is not None:
                hidden |= kpos <= qpos - window
            s.masked_fill_(hidden, NEG_INF)
        w = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
        if hidden is not None:
            w.masked_fill_(hidden, 0.0)
        w = w.div_(w.sum(dim=-1, keepdim=True).clamp_min_(1e-30))
        out[:, i:j] = torch.bmm(w, vf)
        del s, w
    return out
