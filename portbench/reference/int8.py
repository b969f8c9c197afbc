"""The INT8 chain's integer arithmetic and its power-of-two PTQ, frozen.

Part of the yardstick: the plain reference that decides ``correct``. It
imports nothing of the program under test. Semantics (paper §4.3.2):

    acc = x_int8 @ w_int8 (int32, two's-complement wrap) + b_int32
    acc = max(acc, 0)                       (where the layer has a ReLU)
    y   = sat8(round_half_away(acc >> shift))

Products run in float64, exact while |acc| < 2**53, then wrap to int32 as an
int32 accumulator does. ``bits=4`` computes the same model with every
operand of a product, and every result, on the 4-bit grid (the low 4 bits
of each int8 value rounded off): the lower-precision control that the
comparison must reject.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

INT8_MIN, INT8_MAX = -128, 127


@dataclasses.dataclass(frozen=True)
class Layer:
    """One INT8 dense layer: w (K, N) int8, b (N,) int32 or None."""

    w: torch.Tensor
    b: Optional[torch.Tensor]
    shift: int
    relu: bool
    e_w: int
    e_out: int


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w of integer-valued (M, K) and (K, N) tensors in int32, wrapped."""
    acc = x.to(torch.float64) @ w.to(torch.float64)
    return acc.to(torch.int64).to(torch.int32)


def requantize(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 -> int8: shift right rounding half away from zero, saturate."""
    if shift > 0:
        acc = (acc + (1 << (shift - 1)) - (acc < 0).to(acc.dtype)) >> shift
    return acc.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


def on_grid(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 values kept to ``bits`` bits (as int32 on the int8 scale)."""
    q = q.to(torch.int32)
    if bits == 8:
        return q
    drop = 8 - bits
    top = (1 << (bits - 1)) - 1
    r = (q + (1 << (drop - 1)) - (q < 0).to(q.dtype)) >> drop
    return r.clamp(-top - 1, top) << drop


def dense(a: torch.Tensor, layer: Layer, bits: int = 8) -> torch.Tensor:
    acc = product(on_grid(a, bits), on_grid(layer.w, bits))
    if layer.b is not None:
        acc = acc + layer.b.to(torch.int32)
    if layer.relu:
        acc = acc.clamp_min(0)
    return on_grid(requantize(acc, layer.shift), bits).to(torch.int8)


def chain(x: torch.Tensor, layers: Sequence[Layer], bits: int = 8
          ) -> torch.Tensor:
    """Every layer in turn on rows x (M, K0) int8 -> (M, N_last) int8."""
    a = x
    for layer in layers:
        a = dense(a, layer, bits)
    return a


# ---- power-of-two post-training quantization (numpy, on the host) ----------

def pow2_exponent(a: np.ndarray, percentile: float = 100.0) -> int:
    """Smallest e with |a|_percentile / 2**e <= 127."""
    a = np.abs(np.asarray(a))
    amax = float(np.percentile(a, percentile) if percentile < 100.0
                 else np.max(a)) or 1e-8
    return int(np.ceil(np.log2(max(amax, 1e-8) / INT8_MAX)))


def quantize_weight(w: np.ndarray):
    e = pow2_exponent(w)
    a = np.asarray(w, np.float32)
    q = np.clip(np.round(a / np.float32(2.0 ** e)), INT8_MIN, INT8_MAX)
    return q.astype(np.int8), e


def quantize_activations(x, e: int) -> torch.Tensor:
    """Float activations (a tensor) on the int8 grid of scale 2**e."""
    return torch.clamp(torch.round(x * 2.0 ** -e), INT8_MIN, INT8_MAX
                       ).to(torch.int8)


def ptq(weights: Sequence[np.ndarray], biases: Sequence[np.ndarray],
        relus: Sequence[bool], sample: np.ndarray, *,
        e_in: Optional[int] = None, percentile: float = 99.5, device="cpu"):
    """(e_in, layers): each layer's weight scale from its max, each output
    scale from the float activations of ``sample`` at ``percentile``, the
    shift the difference of the two, the bias at the accumulator's scale.
    ``e_in`` fixes the input scale instead of calibrating it."""
    if e_in is None:
        e_in = pow2_exponent(sample, percentile)
    x = np.asarray(sample, np.float32)
    e_prev = e_in
    layers: List[Layer] = []
    for w, b, relu in zip(weights, biases, relus):
        y = x @ w + b
        if relu:
            y = np.maximum(y, 0.0)
        w_q, e_w = quantize_weight(w)
        acc_e = e_prev + e_w
        shift = max(0, pow2_exponent(y, percentile) - acc_e)
        b_q = np.round(b / (2.0 ** acc_e)).astype(np.int32)
        layers.append(Layer(
            w=torch.from_numpy(w_q).to(device),
            b=torch.from_numpy(b_q).to(device), shift=shift, relu=bool(relu),
            e_w=e_w, e_out=acc_e + shift))
        x = y
        e_prev = acc_e + shift
    return e_in, layers


def float_chain(x: np.ndarray, weights, biases, relus) -> np.ndarray:
    for w, b, relu in zip(weights, biases, relus):
        x = x @ w + b
        if relu:
            x = np.maximum(x, 0.0)
    return x
