"""Float DeepSets for jet tagging (paper Table 3 Deepsets-* workloads).

phi MLP per particle -> permutation-invariant aggregation over the set
(mean/sum) -> rho MLP -> class logits. ``to_quantized`` yields the
(phi, rho) ``QuantizedMLP`` pair the fused ``deepsets`` kernel consumes.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.quant import QuantizedMLP, quantize_mlp
from .mlp import (MLP, cross_entropy, mlp_init,
                  params_from_numpy as mlp_params_from_numpy)


class DeepSets(nn.Module):
    def __init__(self, phi: MLP, rho: MLP):
        super().__init__()
        self.phi = phi
        self.rho = rho

    def forward(self, x: torch.Tensor, *, agg: str = "mean") -> torch.Tensor:
        """x (B, M, F) or (M, F) -> logits (B, C) or (C,)."""
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        # phi runs per particle, with ReLU after every layer (the aggregation
        # consumes post-activation features, matching the paper's pipeline)
        h = self.phi(x, relu_last=True)
        g = h.mean(dim=1) if agg == "mean" else h.sum(dim=1)
        out = self.rho(g)
        return out[0] if squeeze else out


def deepsets_init(in_features: int, phi_nodes: Sequence[int],
                  rho_nodes: Sequence[int], *,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> DeepSets:
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    return DeepSets(
        mlp_init(in_features, list(phi_nodes), generator=g, device=device),
        mlp_init(phi_nodes[-1], list(rho_nodes), generator=g, device=device))


def params_from_numpy(params: Dict[str, Sequence[Dict[str, np.ndarray]]],
                      device="cuda") -> DeepSets:
    """A DeepSets holding ``{"phi": [...], "rho": [...]}`` float parameters
    in the JAX package's layout."""
    return DeepSets(mlp_params_from_numpy(params["phi"], device),
                    mlp_params_from_numpy(params["rho"], device))


def deepsets_loss(model: DeepSets, x: torch.Tensor, labels: torch.Tensor,
                  *, agg: str = "mean") -> torch.Tensor:
    return cross_entropy(model(x, agg=agg), labels)


def to_quantized(model: DeepSets, sample_input, *, agg: str = "mean"
                 ) -> Tuple[QuantizedMLP, QuantizedMLP]:
    """PTQ both stages (on the CPU). The rho calibration input is the
    aggregated phi output over the calibration set.

    The fused kernel reduces over the *padded* power-of-two set size with a
    bit-shift (paper §4.3.1); calibration uses the same padded divisor so
    the integer outputs agree bit for bit.
    """
    x = np.asarray(sample_input)
    if x.ndim == 2:
        x = x[None]
    _, m, f = x.shape
    mp = 1 << (m - 1).bit_length()

    def stage(mlp: MLP):
        return ([p.w.detach().cpu().numpy() for p in mlp.layers],
                [p.b.detach().cpu().numpy() for p in mlp.layers])

    phi_w, phi_b = stage(model.phi)
    qphi = quantize_mlp(phi_w, phi_b, [True] * len(phi_w), x.reshape(-1, f))

    dev = model.phi.layers[0].w.device
    with torch.no_grad():
        h = model.phi(torch.from_numpy(x.astype(np.float32)).to(dev),
                      relu_last=True).cpu().numpy()
    g = h.sum(axis=1) / mp if agg == "mean" else h.sum(axis=1)
    rho_w, rho_b = stage(model.rho)
    rho_relu = [i < len(rho_w) - 1 for i in range(len(rho_w))]
    qrho = quantize_mlp(rho_w, rho_b, rho_relu, g)
    return qphi, qrho
