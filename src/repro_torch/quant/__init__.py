"""INT8 symmetric quantization with power-of-two scales (paper §4.3.2).

Activations and weights are INT8 symmetric; scales are powers of two, so the
requantization of the INT32 accumulator back to INT8 is one arithmetic right
shift. Bias is stored INT32 at the accumulator scale.

    y_int32 = x_int8 @ w_int8 + b_int32
    y_int8  = clip( (relu(y_int32)) >> shift, -128, 127 )

PTQ calibration runs in numpy, exactly as in the JAX package; its results
become torch tensors. Two details keep the port bit-exact with it: weights
are divided in float32 (the JAX package casts float64 input down before
dividing) and rounded half-to-even, and biases are rounded by numpy in the
dtype they were given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

INT8_MIN, INT8_MAX = -128, 127


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pow2_scale_exponent(x, *, percentile: float = 100.0) -> int:
    """Smallest power-of-two exponent e with |x|_{percentile} / 2^e <= 127.

    ``percentile < 100`` clips activation outliers instead of stretching the
    grid to cover them; weights keep percentile=100.
    """
    a = np.abs(_numpy(x))
    amax = float(np.percentile(a, percentile) if percentile < 100.0
                 else np.max(a)) or 1e-8
    amax = max(amax, 1e-8)
    return int(np.ceil(np.log2(amax / INT8_MAX)))


def quantize_pow2(x) -> Tuple[torch.Tensor, int]:
    """Symmetric INT8 quantization with a power-of-two scale 2^e.

    Returns (q, e) with  x ~= q * 2^e; q is a CPU int8 tensor.
    """
    e = pow2_scale_exponent(x)
    a = _numpy(x).astype(np.float32)
    q = np.clip(np.round(a / np.float32(2.0 ** e)), INT8_MIN, INT8_MAX)
    return torch.from_numpy(q.astype(np.int8)), e


def dequantize_pow2(q: torch.Tensor, e: int) -> torch.Tensor:
    return q.to(torch.float32) * (2.0 ** e)


def requantize_shift(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """INT32 accumulator -> INT8 by arithmetic right shift (paper: bit-shift).

    ``shift`` >= 0. Rounds half away from zero on the shifted-out bits (the
    AIE SRS instruction); the add wraps in int32 as the reference's does.
    """
    if shift > 0:
        half = 1 << (shift - 1)
        acc = (acc + half - (acc < 0).to(acc.dtype)) >> shift
    return acc.clamp(INT8_MIN, INT8_MAX).to(torch.int8)


@dataclasses.dataclass(frozen=True, eq=False)
class QuantizedLinear:
    """One INT8 dense layer: w_q (K, N) int8, bias int32, output shift."""

    w_q: torch.Tensor
    bias_q: Optional[torch.Tensor]  # (N,) int32, scale = 2^(e_x + e_w)
    shift: int                      # e_out - e_x - e_w, >= 0
    relu: bool
    e_w: int                        # weight scale exponent
    e_out: int                      # output activation scale exponent

    def __post_init__(self):
        if self.w_q.dtype != torch.int8 or self.w_q.dim() != 2:
            raise ValueError(f"w_q must be 2-D int8, got {self.w_q.dtype} "
                             f"{tuple(self.w_q.shape)}")
        if self.bias_q is not None and (
                self.bias_q.dtype != torch.int32
                or tuple(self.bias_q.shape) != (self.w_q.shape[1],)):
            raise ValueError("bias_q must be int32 of shape (N,)")
        if self.shift < 0:
            raise ValueError(f"shift must be >= 0, got {self.shift}")

    def to(self, device) -> "QuantizedLinear":
        return dataclasses.replace(
            self, w_q=self.w_q.to(device),
            bias_q=None if self.bias_q is None else self.bias_q.to(device))


@dataclasses.dataclass(frozen=True, eq=False)
class QuantizedMLP:
    """A fully-quantized MLP: input scale exponent + per-layer params.

    Compared by identity (``eq=False``) so that the kernels can cache their
    packed weights per model.
    """

    e_in: int
    layers: Tuple[QuantizedLinear, ...]

    @property
    def device(self) -> torch.device:
        return self.layers[0].w_q.device

    def to(self, device) -> "QuantizedMLP":
        """This model with every tensor on ``device`` (self if already there)."""
        device = torch.device(device)
        if all(l.w_q.device == device for l in self.layers):
            return self
        return QuantizedMLP(e_in=self.e_in,
                            layers=tuple(l.to(device) for l in self.layers))

    @classmethod
    def from_arrays(cls, obj: Any) -> "QuantizedMLP":
        """Build from any object with ``.e_in`` and
        ``.layers[i].{w_q, bias_q, shift, relu, e_w, e_out}``, each read
        through ``np.asarray`` (duck-typed: the JAX package's
        ``QuantizedMLP`` carries across without this package importing it)."""
        layers = []
        for l in obj.layers:
            b = None if l.bias_q is None else torch.from_numpy(
                np.array(np.asarray(l.bias_q), np.int32))
            layers.append(QuantizedLinear(
                w_q=torch.from_numpy(np.array(np.asarray(l.w_q), np.int8)),
                bias_q=b, shift=int(l.shift), relu=bool(l.relu),
                e_w=int(l.e_w), e_out=int(l.e_out)))
        return cls(e_in=int(obj.e_in), layers=tuple(layers))


def quantize_mlp(weights: Sequence[np.ndarray],
                 biases: Sequence[Optional[np.ndarray]],
                 relus: Sequence[bool],
                 sample_input: np.ndarray,
                 act_exponents: Optional[Sequence[int]] = None,
                 act_percentile: float = 99.5) -> QuantizedMLP:
    """Post-training quantization of a float MLP to the paper's scheme.

    Activation scale exponents are calibrated by propagating ``sample_input``
    through the float network in numpy (or taken from ``act_exponents``),
    using percentile clipping (see :func:`pow2_scale_exponent`). The result
    lies on the CPU; ``QuantizedMLP.to`` moves it.
    """
    e_in = pow2_scale_exponent(sample_input, percentile=act_percentile)
    x = np.asarray(sample_input, np.float32)
    e_prev = e_in
    layers: List[QuantizedLinear] = []
    for i, (w, b, relu) in enumerate(zip(weights, biases, relus)):
        w = np.asarray(w)
        b = None if b is None else np.asarray(b)
        y = x @ w + (b if b is not None else 0.0)
        if relu:
            y = np.maximum(y, 0.0)
        e_out = (act_exponents[i] if act_exponents is not None
                 else pow2_scale_exponent(y, percentile=act_percentile))
        w_q, e_w = quantize_pow2(w)
        acc_e = e_prev + e_w
        shift = max(0, e_out - acc_e)
        e_out = acc_e + shift            # realizable output exponent
        b_q = None
        if b is not None:
            b_q = torch.from_numpy(np.round(b / (2.0 ** acc_e)).astype(np.int32))
        layers.append(QuantizedLinear(w_q=w_q, bias_q=b_q, shift=shift,
                                      relu=relu, e_w=e_w, e_out=e_out))
        x = y
        e_prev = e_out
    return QuantizedMLP(e_in=e_in, layers=tuple(layers))


__all__ = ["INT8_MIN", "INT8_MAX", "pow2_scale_exponent", "quantize_pow2",
           "dequantize_pow2", "requantize_shift", "QuantizedLinear",
           "QuantizedMLP", "quantize_mlp"]
