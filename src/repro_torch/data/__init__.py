"""Data pipeline: synthetic jet-tagging streams (paper Table 3 workloads)
and LM token streams, with host-side prefetch and device placement.

A copy of ``src/repro/data/__init__.py``. Jet events: each class is a
distinct covariance and pT spectrum, so the taggers have real structure to
learn. LM tokens: a Zipfian bigram process, so the loss can fall. Both are
numpy, and the same seed gives the same events and tokens as the JAX
package. ``Prefetcher`` places each batch on a ``torch.device`` where the
reference takes a JAX sharding.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# LM token stream: Zipfian bigram process (learnable, no external data)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int = 256
    seq_len: int = 128
    branching: int = 16        #: successors per token (lower = easier)
    seed: int = 0


class BigramSampler:
    """Each token has `branching` plausible successors with Zipf weights:
    a stationary process with ~log2(branching) bits/token entropy floor."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.succ = rng.integers(0, cfg.vocab,
                                 (cfg.vocab, cfg.branching)).astype(np.int32)
        w = 1.0 / np.arange(1, cfg.branching + 1) ** 1.2
        self.w = (w / w.sum()).astype(np.float64)

    def batch(self, batch: int, seed: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        toks = np.empty((batch, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, batch)
        choices = rng.choice(cfg.branching, size=(batch, cfg.seq_len),
                             p=self.w)
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return toks

    def stream(self, batch: int, *, start_seed: int = 1
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        s = start_seed
        while True:
            toks = self.batch(batch, s)
            yield toks[:, :-1], toks[:, 1:]
            s += 1


# ---------------------------------------------------------------------------
# Host-side prefetch + device placement
# ---------------------------------------------------------------------------

def place(tree, device: torch.device):
    """Every numpy array or tensor of a dict / list / tuple as a tensor on
    ``device`` (``None`` stays ``None``); to CUDA through pinned memory,
    copied without blocking."""
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, device) for v in tree)
    if tree is None:
        return None
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(tree))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Prefetcher:
    """Background-thread prefetch of host batches, optionally placing them
    on ``device`` (overlaps host data work with device compute) and then on
    a mesh with ``sharding`` (a ``launch.mesh.NamedSharding``: each tensor
    becomes a DTensor, in the consumer's thread)."""

    def __init__(self, it: Iterator, *, depth: int = 2,
                 device: Optional[torch.device] = None, sharding=None):
        self._it = it
        self._device = None if device is None else torch.device(device)
        self._sharding = sharding
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for b in self._it:
                self._q.put(b if self._device is None
                            else place(b, self._device))
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        if self._sharding is None:
            return item
        from repro_torch._tree import tree_map
        from repro_torch.distributed.planner import shard_tensor
        return tree_map(lambda t: shard_tensor(t, self._sharding), item)


__all__ = ["JetConfig", "jet_batch", "jet_stream", "LMDataConfig",
           "BigramSampler", "Prefetcher", "place"]
