"""Plain PyTorch versions of the fused cascade MLP / DeepSets kernels.

They run on either device and take a leading batch axis where noted.
"""
from __future__ import annotations

import torch

from repro_torch.quant import QuantizedMLP, requantize_shift
from repro_torch.kernels.mm_int8.ref import mm_int8_ref


def cascade_mlp_ref(x: torch.Tensor, qmlp: QuantizedMLP) -> torch.Tensor:
    """Layer-by-layer: y_i = requant(relu(y_{i-1} @ w_i + b_i)); x (M, K0)."""
    a = x
    for layer in qmlp.layers:
        a = mm_int8_ref(a, layer.w_q, layer.bias_q, shift=layer.shift,
                        relu=layer.relu)
    return a


def global_agg_ref(x: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """Sum/mean over the set axis (-2) in INT32, keeping that axis.

    'sum' stays INT32; 'mean' is INT8 by the power-of-two shift log2(M).
    """
    acc = x.to(torch.int32).sum(dim=-2, keepdim=True, dtype=torch.int32)
    if op == "sum":
        return acc
    m = x.shape[-2]
    if m & (m - 1):
        raise ValueError("mean reduction needs a power-of-two M")
    return requantize_shift(acc, m.bit_length() - 1)


def deepsets_ref(x: torch.Tensor, phi: QuantizedMLP, rho: QuantizedMLP, *,
                 agg: str = "mean") -> torch.Tensor:
    """phi MLP -> global aggregation -> rho MLP, all INT8/INT32.

    x: (M, F) -> (1, n_out), or (B, M, F) -> (B, 1, n_out); M a power of two.
    Both aggregations requantize the INT32 sum by log2(M) before rho.
    """
    m, f = x.shape[-2:]
    if m & (m - 1):
        raise ValueError("deepsets_ref needs a power-of-two set size")
    lead = x.shape[:-2]
    h = cascade_mlp_ref(x.reshape(-1, f), phi)
    h = h.reshape(*lead, m, h.shape[-1])
    g = global_agg_ref(h, op="sum")
    g = requantize_shift(g, m.bit_length() - 1)
    out = cascade_mlp_ref(g.reshape(-1, g.shape[-1]), rho)
    return out.reshape(*lead, 1, out.shape[-1])
