"""Public wrapper of the grouped MoE experts kernel (K6): its tile table,
checks, launch.

K6 (``csrc/moe_grouped.cu``) runs a MoE layer's held experts on the rows that
``models.moe.dispatch`` sorted by held expert, sized by tables that stay on
the device: the experts' row counts and offsets, the dispatch's inverse
permutation, and the tile table that :func:`tile_table` builds from them
there. The host never waits for the experts' row counts. Scratch is sized
for the worst case, every (token, choice) held: h (tokens·top_k, f) bf16 and
an f32 row buffer (tokens·top_k, d).

Its plain version is the layer's loop over the held experts
(``models.moe._experts_loop``), which reads the counts on the host. This
wrapper takes CUDA tensors only and raises on anything else, and on inputs
that would need a gradient (it has no backward); the layer decides which of
the two runs (``models.moe.takes_k6``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: Sorted rows a tile (``kRows`` in csrc/moe_grouped.cu).
BLOCK_ROWS = 192
#: Columns of f a work item of the gate/up pass takes, of d one of the down
#: pass (``kColsGateUp``, ``kColsDown``): f and d must be multiples.
COLS_GATE_UP = 128
COLS_DOWN = 256


def fits(d: int, f: int) -> bool:
    """True where K6's tiles divide the model width d and the expert width
    f."""
    return d > 0 and f > 0 and d % COLS_DOWN == 0 and f % COLS_GATE_UP == 0


def max_tiles(rows: int, n: int) -> int:
    """Tiles enough for ``rows`` sorted rows over ``n`` experts, however
    they split: each expert's last tile may be partial."""
    return -(-rows // BLOCK_ROWS) + n


def tile_table(counts: torch.Tensor, offsets: torch.Tensor, rows: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's work list, on the counts' device with no copy to the host: from
    the held experts' row counts (n,) int64 and their first sorted rows
    ``offsets`` (n + 1,), of at most ``rows`` rows in all, (tiles
    (``max_tiles(rows, n)``, 2) int64: each tile's expert and first sorted
    row, in expert order, ``BLOCK_ROWS`` rows a tile but an expert's last;
    n_tiles (1,) int64: the tiles in use). Rows past n_tiles are never
    read."""
    n = counts.shape[0]
    per = (counts + (BLOCK_ROWS - 1)) // BLOCK_ROWS
    first_tile = F.pad(per.cumsum(0), (1, 0))
    t = torch.arange(max_tiles(rows, n), device=counts.device)
    e = torch.searchsorted(first_tile, t, right=True) - 1
    start = offsets[e] + (t - first_tile[e]) * BLOCK_ROWS
    return torch.stack((e, start), dim=1), first_tile[n:]


def moe_grouped(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, token: torch.Tensor, weight: torch.Tensor,
                counts: torch.Tensor, offsets: torch.Tensor,
                inverse: torch.Tensor, top_k: int,
                add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The held experts' SwiGLUs on x (T, d) bf16, combined -> (T, d) bf16.

    wg, wu (n, d, f) and wd (n, f, d): the held experts' bf16 stacks;
    token, weight, inverse (T·top_k,): each sorted row's token and combine
    weight (f32), each (token, choice)'s sorted row; counts (n,) and
    offsets (n + 1,): each held expert's rows and first sorted row, int64.
    ``add`` (T, d) bf16, the shared expert's output, is added in bf16 after
    the experts' sum is rounded. One call: the tile table on the device
    (``tile_table``), then three launches (gate/up, down, combine)."""
    grads = (x, wg, wu, wd, weight) + (() if add is None else (add,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        raise RuntimeError(
            "the grouped MoE kernel (K6) has no backward: call it under "
            "torch.no_grad() / inference_mode, or on tensors that do not "
            "require grad")
    tables = (token, counts, offsets, inverse)
    ts = (x, wg, wu, wd, weight, *tables) + (() if add is None else (add,))
    if _build.on_cpu(*ts):
        raise ValueError("K6 takes CUDA tensors; on the CPU the layer runs "
                         "its loop over the held experts")
    if x.dim() != 2 or wg.dim() != 3 or wu.shape != wg.shape:
        raise ValueError(f"x (T, d), wg and wu (n, d, f); got "
                         f"{tuple(x.shape)}, {tuple(wg.shape)}, "
                         f"{tuple(wu.shape)}")
    T, d = x.shape
    n, _, f = wg.shape
    rows = T * top_k
    if (wg.shape[1] != d or wd.shape != (n, f, d) or counts.shape != (n,)
            or offsets.shape != (n + 1,)
            or any(t.shape != (rows,) for t in (token, weight, inverse))
            or (add is not None and add.shape != x.shape)):
        raise ValueError("K6's operands do not fit x "
                         f"{tuple(x.shape)} and wg {tuple(wg.shape)}")
    bf16 = [x, wg, wu, wd] + ([] if add is None else [add])
    if any(t.dtype != torch.bfloat16 for t in bf16) or \
            weight.dtype != torch.float32 or \
            any(t.dtype != torch.int64 for t in tables):
        raise ValueError("K6 takes bf16 activations and stacks, an f32 "
                         "weight and int64 tables")
    if not fits(d, f):
        raise ValueError(f"K6's tiles need d % {COLS_DOWN} == 0 and f % "
                         f"{COLS_GATE_UP} == 0; got d={d}, f={f}")
    _build.require_contiguous(x=x, wg=wg, wu=wu, wd=wd, token=token,
                              weight=weight, offsets=offsets, inverse=inverse,
                              **({} if add is None else {"add": add}))
    tiles, n_tiles = tile_table(counts, offsets, rows)
    h = torch.empty((rows, f), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    code = _build.library().moe_grouped_launch(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        token.data_ptr(), weight.data_ptr(), offsets.data_ptr(),
        tiles.data_ptr(), n_tiles.data_ptr(), inverse.data_ptr(),
        None if add is None else add.data_ptr(), h.data_ptr(), y.data_ptr(),
        out.data_ptr(), T, top_k, n, d, f, tiles.shape[0],
        _build.stream_of(x))
    _build.check(code, "moe_grouped")
    _build.launches.add("moe_grouped")
    return out
