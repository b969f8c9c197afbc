"""Seeded synthetic jets and seeded float weights, made on the device.

The jets follow the arithmetic of the program's own generator (each class a
distinct mean, spread and pT-ordered decay along the set), drawn here with
``torch.Generator`` on the device in a few large calls, so that a pool of
hundreds of MB costs milliseconds. The same seed gives the same numbers.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .int8 import quantize_activations

CHUNK_EVENTS = 1 << 15      # events drawn a call, so the float draw stays small


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for each (seed, stream)."""
    state = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


class Jets:
    """Events of ``m`` particles x ``f`` features from ``classes`` classes;
    the class structure is fixed by ``gen`` at construction."""

    def __init__(self, m: int, f: int, classes: int, gen: torch.Generator,
                 device):
        self.m, self.f, self.classes, self.device = m, f, classes, device
        self.mu = torch.randn(classes, f, generator=gen, device=device) * 0.8
        u = torch.rand(classes, f + 1, generator=gen, device=device)
        self.sig = 0.4 + 0.8 * u[:, :f]
        decay = 0.85 + 0.1 * u[:, f]
        self.fall = decay[:, None] ** torch.arange(m, device=device)[None, :]

    def sample(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """(n, m, f) float32 events."""
        labels = torch.randint(0, self.classes, (n,), generator=gen,
                               device=self.device)
        x = torch.randn(n, self.m, self.f, generator=gen, device=self.device)
        x = x * self.sig[labels][:, None, :] + self.mu[labels][:, None, :]
        return x * self.fall[labels][:, :, None]


def float_layers(widths: Sequence[int], bias_std: float,
                 gen: torch.Generator, device
                 ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """He-initialised float weights (K, N) and normal biases for the chain
    widths[0] -> widths[1] -> ..., drawn in two calls, as host arrays."""
    shapes = list(zip(widths[:-1], widths[1:]))
    w_all = torch.randn(sum(k * n for k, n in shapes), generator=gen,
                        device=device).cpu().numpy()
    b_all = torch.randn(sum(n for _, n in shapes), generator=gen,
                        device=device).cpu().numpy() * np.float32(bias_std)
    weights, biases, wo, bo = [], [], 0, 0
    for k, n in shapes:
        weights.append(w_all[wo:wo + k * n].reshape(k, n)
                       * np.float32(np.sqrt(2.0 / k)))
        biases.append(b_all[bo:bo + n])
        wo += k * n
        bo += n
    return weights, biases


def seeded_inputs(cfg: dict, traffic: dict, seed: int, device,
                  event_shape: Tuple[int, int], make_model: Callable,
                  to_input: Callable):
    """(model, pool) of a cell, from the seed: the model made by
    ``make_model`` and quantized on ``calibration_events`` seeded jets, then
    ``pool_batches`` batches of ``batch_events`` jets on the model's input
    grid, each as the port takes it (``to_input``)."""
    ev = Jets(*event_shape, cfg["classes"], generator(seed, 0, device),
              device)
    calib = ev.sample(cfg["ptq"]["calibration_events"],
                      generator(seed, 2, device)).cpu().numpy()
    model = make_model(cfg, calib, generator(seed, 1, device), device)
    g = generator(seed, 3, device)
    n = traffic["pool_batches"] * traffic["batch_events"]
    events = torch.cat([quantize_activations(
        ev.sample(min(CHUNK_EVENTS, n - s), g), model["e_in"])
        for s in range(0, n, CHUNK_EVENTS)])
    return model, [to_input(cfg, b)
                   for b in events.split(traffic["batch_events"])]
