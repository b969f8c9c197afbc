"""Float MLP for the paper's jet-tagging workloads (JSC-M/XL).

The layout is the JAX package's: layer i holds ``w`` (K, N) and ``b`` (N,)
and computes ``y = x @ w + b``, so float parameters carry across both ways.
Training runs in float32; deployment quantizes to the paper's INT8
power-of-two scheme (:func:`to_quantized`) and serves through the fused
cascade kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.quant import QuantizedMLP, quantize_mlp


class Dense(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class MLP(nn.Module):
    """Dense stack with ReLU between layers (and after the last when asked)."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, *, relu_last: bool = False
                ) -> torch.Tensor:
        """x (..., in_features) -> logits (..., nodes[-1])."""
        for i, p in enumerate(self.layers):
            x = x @ p.w + p.b
            if relu_last or i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def mlp_init(in_features: int, nodes: Sequence[int], *,
             generator: Optional[torch.Generator] = None,
             device="cuda") -> MLP:
    """He-initialized dense stack: in_features -> nodes[0] -> ... -> nodes[-1].

    The numbers are drawn on the CPU from ``generator`` and then moved, so a
    seed gives the same model on every device.
    """
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    layers, k = [], in_features
    for n in nodes:
        w = torch.randn(k, n, generator=g) * math.sqrt(2.0 / k)
        layers.append(Dense(w.to(dev), torch.zeros(n, device=dev)))
        k = n
    return MLP(layers)


def params_from_numpy(params: Sequence[Dict[str, np.ndarray]],
                      device="cuda") -> MLP:
    """An MLP holding the given ``[{"w": (K, N), "b": (N,)}, ...]`` float
    parameters (for example the JAX package's, through ``np.asarray``)."""
    dev = resolve_device(device)
    return MLP([Dense(torch.tensor(np.asarray(p["w"]), dtype=torch.float32,
                                   device=dev),
                      torch.tensor(np.asarray(p["b"]), dtype=torch.float32,
                                   device=dev))
                for p in params])


def mlp_loss(model: MLP, x: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
    """Cross-entropy over the per-jet class logits.

    x (B, M, F): the JSC MLPs run per-particle rows through the stack and
    take the mean over the M rows of the per-row class scores.
    """
    logits = model(x)
    if logits.dim() == 3:
        logits = logits.mean(dim=1)
    return cross_entropy(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of -log softmax(logits)[label]. Picks the label by a one-hot
    product, whose gradient, unlike a gather's, has no atomics on CUDA: the
    same seed trains the same weights on every run."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -(logp * onehot).sum(dim=-1).mean()


def to_quantized(model: MLP, sample_input, *, relu_last: bool = False
                 ) -> QuantizedMLP:
    """Post-training quantization to the paper's INT8/pow2 scheme (on the CPU;
    ``QuantizedMLP.to`` moves the result)."""
    weights = [p.w.detach().cpu().numpy() for p in model.layers]
    biases = [p.b.detach().cpu().numpy() for p in model.layers]
    n = len(model.layers)
    relus = [relu_last or i < n - 1 for i in range(n)]
    x = np.asarray(sample_input)
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    return quantize_mlp(weights, biases, relus, x)
