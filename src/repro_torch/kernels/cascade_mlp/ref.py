"""Plain PyTorch versions of the fused cascade MLP / DeepSets kernels.

They run on either device and take a leading batch axis where noted.
"""
from __future__ import annotations

import torch

from repro_torch.quant import QuantizedMLP, requantize_shift
from repro_torch.kernels.global_agg.ref import global_agg_ref
from repro_torch.kernels.mm_int8.ref import mm_int8_ref


def cascade_mlp_ref(x: torch.Tensor, qmlp: QuantizedMLP) -> torch.Tensor:
    """Layer-by-layer: y_i = requant(relu(y_{i-1} @ w_i + b_i)); x (M, K0)."""
    a = x
    for layer in qmlp.layers:
        a = mm_int8_ref(a, layer.w_q, layer.bias_q, shift=layer.shift,
                        relu=layer.relu)
    return a


def deepsets_ref(x: torch.Tensor, phi: QuantizedMLP, rho: QuantizedMLP, *,
                 agg: str = "mean") -> torch.Tensor:
    """phi MLP -> global aggregation -> rho MLP, all INT8/INT32.

    x: (M, F) -> (1, n_out), or (B, M, F) -> (B, 1, n_out). Both aggregations
    requantize the INT32 sum by floor(log2 M) before rho; 'mean' takes only
    a power-of-two M, 'sum' any M.
    """
    if agg not in ("mean", "sum"):
        raise ValueError(f"agg must be 'mean' or 'sum', got {agg!r}")
    m, f = x.shape[-2:]
    if agg == "mean" and m & (m - 1):
        raise ValueError("deepsets_ref with agg='mean' needs a power-of-two "
                         "set size")
    lead = x.shape[:-2]
    h = cascade_mlp_ref(x.reshape(-1, f), phi)
    h = h.reshape(*lead, m, h.shape[-1])
    g = global_agg_ref(h, op="sum")
    g = requantize_shift(g, m.bit_length() - 1)
    out = cascade_mlp_ref(g.reshape(-1, g.shape[-1]), rho)
    return out.reshape(*lead, 1, out.shape[-1])
