"""Synthetic jet-tagging streams (paper Table 3 workloads), pure numpy.

A copy of the jet half of ``repro/data/__init__.py``: each class is a
distinct covariance and pT spectrum, so the taggers have real structure to
learn. The same seed gives the same events as the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class JetConfig:
    n_particles: int = 64       #: set size M
    n_features: int = 16        #: per-particle features
    n_classes: int = 5
    seed: int = 0


def jet_batch(cfg: JetConfig, batch: int, seed: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic jets: each class is a distinct covariance + pT spectrum.

    Returns (x (batch, M, F) float32, labels (batch,) int32).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.n_classes, batch)
    # class-dependent structure: mean direction + spread + multiplicity decay
    base = np.random.default_rng(cfg.seed)
    mu = base.normal(0, 0.8, (cfg.n_classes, cfg.n_features))
    sig = 0.4 + base.uniform(0, 0.8, (cfg.n_classes, cfg.n_features))
    decay = 0.85 + 0.1 * base.uniform(0, 1, cfg.n_classes)
    x = rng.normal(0, 1, (batch, cfg.n_particles, cfg.n_features))
    x = x * sig[labels][:, None, :] + mu[labels][:, None, :]
    # pT-ordered multiplicity: later particles decay toward zero padding
    ranks = np.arange(cfg.n_particles)[None, :, None]
    x = x * (decay[labels][:, None, None] ** ranks)
    return x.astype(np.float32), labels.astype(np.int32)


def jet_stream(cfg: JetConfig, batch: int, *, start_seed: int = 1
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    s = start_seed
    while True:
        yield jet_batch(cfg, batch, s)
        s += 1


__all__ = ["JetConfig", "jet_batch", "jet_stream"]
