"""A float kind for the tests alone, absent from BENCHMARK.json: what a
float model brings to the harness, in one module. ``CONFIG`` is its
configuration, stating a ``"compare"`` tolerance and a ``"peak"``; the
reference's part (``make_inputs``, ``forward``, ``lower_precision`` and the
counts) is plain float32 PyTorch, as ``reference/<kind>.py`` would be;
``build`` stands in for ``port/<kind>.py``: the same MLP in bf16, with its
activations in bf16 between layers, as a bf16 program serves it.

An event is ``rows`` rows of ``widths[0]`` features; every row goes through
``widths[0] -> ... -> widths[-1]``, ReLU after each layer but the last.
Weights and events are made in bf16, the type they are served in, so the
reference reads exactly what the port reads. The control rounds both
operands of every product to e4m3 (``torch.float8_e4m3fn``), the next
precision below bf16, and computes the rest in float32.
"""
from __future__ import annotations

import math

import torch

CONFIG = {
    "name": "float-mlp",
    "kind": "float_mlp",
    "rows": 16,
    "widths": [64, 256, 256, 16],
    "peak": "bf16",
    "compare": {
        "atol": 0.11, "rtol": 0.02, "max_relative_rms": 0.015,
        "why": "bf16 activations between layers against float32, on the "
               "H100 over 16 seeds: relative RMS 0.0027-0.0032, atol needed "
               "at rtol 0.02 0.017-0.020; the e4m3 control on 4 seeds: "
               "0.058-0.075 and 0.53-0.61",
    },
    "reduced": [],
}

E4M3_MAX = 448.0


def _layers(cfg):
    w = cfg["widths"]
    return list(zip(w[:-1], w[1:]))


def ops_per_event(cfg) -> int:
    return cfg["rows"] * sum(2 * k * n for k, n in _layers(cfg))


def bytes_per_event(cfg) -> int:
    """The event's bf16 rows read once and their bf16 scores written once."""
    return cfg["rows"] * 2 * (cfg["widths"][0] + cfg["widths"][-1])


def weight_bytes(cfg) -> int:
    return sum(2 * (k * n + n) for k, n in _layers(cfg))


def events_in(cfg, x: torch.Tensor) -> int:
    return x.shape[0] // cfg["rows"]


def make_inputs(cfg, traffic, seed: int, device):
    """(model, pool) from ``seed``, on the device, in bf16: He-normal
    weights, small normal biases, and ``pool_batches`` batches of
    ``batch_events`` events of normal features."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers = []
    for k, n in _layers(cfg):
        w = torch.randn(k, n, generator=gen, device=device) * math.sqrt(2 / k)
        b = 0.1 * torch.randn(n, generator=gen, device=device)
        layers.append((w.to(torch.bfloat16), b.to(torch.bfloat16)))
    rows = traffic["batch_events"] * cfg["rows"]
    pool = torch.randn(traffic["pool_batches"], rows, cfg["widths"][0],
                       generator=gen, device=device).to(torch.bfloat16)
    return {"layers": layers}, list(pool.unbind(0))


def _chain(x, layers, operand):
    """The MLP in float32, each product's operands through ``operand``."""
    a = x.to(torch.float32)
    last = len(layers) - 1
    for i, (w, b) in enumerate(layers):
        a = operand(a) @ operand(w.to(torch.float32)) + b.to(torch.float32)
        if i < last:
            a = a.clamp_min(0)
    return a


def forward(cfg, model, x: torch.Tensor) -> torch.Tensor:
    """(R, f) bf16 rows -> (R, N_last) float32 scores."""
    return _chain(x, model["layers"], lambda t: t)


def _e4m3(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(
        torch.float32)


def lower_precision(cfg, model):
    """The reference with every product's operands on the e4m3 grid."""
    return lambda x: _chain(x, model["layers"], _e4m3)


def build(cfg, model):
    """The stand-in port: bf16 products, bf16 activations between layers."""
    layers = model["layers"]
    last = len(layers) - 1

    def port_forward(x):
        a = x
        for i, (w, b) in enumerate(layers):
            a = torch.addmm(b, a, w)
            if i < last:
                a = a.clamp_min(0)
        return a
    return port_forward
