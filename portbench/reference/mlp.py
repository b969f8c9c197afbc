"""An MLP over the rows of an event (paper Table 3 JSC models): every row
through the whole chain. One event is (rows, features) int8; its scores are
(rows, N_last) int8."""
from __future__ import annotations

import numpy as np
import torch

from . import int8
from . import jets

BLOCK_ROWS = 1 << 18    # rows the reference holds at once


def _widths(cfg):
    return [cfg["features"]] + cfg["nodes"]


def _macs(widths) -> int:
    return sum(k * n for k, n in zip(widths[:-1], widths[1:]))


def ops_per_event(cfg) -> int:
    """2·K·N a row a layer, at the published widths."""
    return cfg["rows"] * 2 * _macs(_widths(cfg))


def bytes_per_event(cfg) -> int:
    """The event's rows read once and their scores written once."""
    return cfg["rows"] * (cfg["features"] + cfg["nodes"][-1])


def weight_bytes(cfg) -> int:
    """int8 weights and int32 biases, read once a launch."""
    w = _widths(cfg)
    return _macs(w) + 4 * sum(w[1:])


def make_model(cfg, calib: np.ndarray, gen, device) -> dict:
    ptq = cfg["ptq"]
    w, b = jets.float_layers(_widths(cfg), ptq["bias_std"], gen, device)
    e_in, layers = int8.ptq(w, b, cfg["relu"],
                            calib.reshape(-1, calib.shape[-1]),
                            percentile=ptq["act_percentile"], device=device)
    return {"e_in": e_in, "stages": {"mlp": layers}}


def make_inputs(cfg, traffic, seed: int, device):
    """(model, pool): the seeded model and the cell's batches
    (``jets.seeded_inputs``)."""
    return jets.seeded_inputs(cfg, traffic, seed, device,
                              (cfg["rows"], cfg["features"]), make_model, to_input)


def to_input(cfg, events: torch.Tensor) -> torch.Tensor:
    """(n, rows, f) int8 events as the port takes them: (n·rows, f)."""
    return events.reshape(-1, events.shape[-1]).contiguous()


def events_in(cfg, x: torch.Tensor) -> int:
    return x.shape[0] // cfg["rows"]


def forward(cfg, model: dict, x: torch.Tensor, bits: int = 8
            ) -> torch.Tensor:
    """(R, f) int8 rows -> (R, N_last) int8, BLOCK_ROWS at a time."""
    layers = model["stages"]["mlp"]
    return torch.cat([int8.chain(x[s:s + BLOCK_ROWS], layers, bits)
                      for s in range(0, x.shape[0], BLOCK_ROWS)])
