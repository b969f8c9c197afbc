"""DeepSets (paper Table 3): phi on every particle, the set sum requantized
by log2 of the set padded to a power of two, rho on the aggregate. One event
is an (m, f) int8 set; its scores are (1, classes) int8."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import int8
from . import jets

BLOCK_EVENTS = 8192     # events the reference holds at once


def _padded(m: int) -> int:
    return 1 << (m - 1).bit_length()


def _widths(cfg):
    return [cfg["features"]] + cfg["phi"], [cfg["phi"][-1]] + cfg["rho"]


def _macs(widths) -> int:
    return sum(k * n for k, n in zip(widths[:-1], widths[1:]))


def ops_per_event(cfg) -> int:
    """2·K·N a particle a phi layer, one add a particle a feature for the
    set sum, 2·K·N a rho layer, at the published (unpadded) widths."""
    phi, rho = _widths(cfg)
    m = cfg["set_size"]
    return m * 2 * _macs(phi) + m * phi[-1] + 2 * _macs(rho)


def bytes_per_event(cfg) -> int:
    """The event read once and its scores written once."""
    return cfg["set_size"] * cfg["features"] + cfg["rho"][-1]


def weight_bytes(cfg) -> int:
    """int8 weights and int32 biases, read once a launch."""
    phi, rho = _widths(cfg)
    return _macs(phi) + _macs(rho) + 4 * (sum(phi[1:]) + sum(rho[1:]))


def make_model(cfg, calib: np.ndarray, gen, device) -> dict:
    """Seeded float phi and rho, quantized on ``calib`` (n, m, f) float32;
    rho's input scale is phi's output scale, which the int8 mean keeps."""
    ptq = cfg["ptq"]
    phi_w, rho_w = _widths(cfg)
    pw, pb = jets.float_layers(phi_w, ptq["bias_std"], gen, device)
    rw, rb = jets.float_layers(rho_w, ptq["bias_std"], gen, device)
    n, m, f = calib.shape
    rows = calib.reshape(-1, f)
    e_in, phi = int8.ptq(pw, pb, cfg["phi_relu"], rows,
                         percentile=ptq["act_percentile"], device=device)
    h = int8.float_chain(rows, pw, pb, cfg["phi_relu"]).reshape(n, m, -1)
    _, rho = int8.ptq(rw, rb, cfg["rho_relu"], h.sum(axis=1) / _padded(m),
                      e_in=phi[-1].e_out, percentile=ptq["act_percentile"],
                      device=device)
    return {"e_in": e_in, "stages": {"phi": phi, "rho": rho}}


def make_inputs(cfg, traffic, seed: int, device):
    """(model, pool): the seeded model and the cell's batches
    (``jets.seeded_inputs``)."""
    return jets.seeded_inputs(cfg, traffic, seed, device,
                              (cfg["set_size"], cfg["features"]), make_model, to_input)


def to_input(cfg, events: torch.Tensor) -> torch.Tensor:
    """(n, m, f) int8 events as the port takes them: the same."""
    return events.contiguous()


def events_in(cfg, x: torch.Tensor) -> int:
    return x.shape[0]


def forward(cfg, model: dict, x: torch.Tensor, bits: int = 8
            ) -> torch.Tensor:
    """(B, m, f) int8 -> (B, 1, classes) int8, BLOCK_EVENTS at a time."""
    phi, rho = model["stages"]["phi"], model["stages"]["rho"]
    b, m, f = x.shape
    mp = _padded(m)
    outs = []
    for s in range(0, b, BLOCK_EVENTS):
        xb = F.pad(x[s:s + BLOCK_EVENTS], (0, 0, 0, mp - m))
        nb = xb.shape[0]
        h = int8.chain(xb.reshape(-1, f), phi, bits).reshape(nb, mp, -1)
        g = h.to(torch.int32).sum(dim=1, dtype=torch.int32)
        g = int8.on_grid(int8.requantize(g, mp.bit_length() - 1), bits)
        outs.append(int8.chain(g.to(torch.int8), rho, bits)[:, None, :])
    return torch.cat(outs)
