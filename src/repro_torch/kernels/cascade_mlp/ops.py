"""Public wrappers of the fused cascade MLP (K2) and DeepSets (K3) kernels.

A CPU tensor goes to the plain versions in ``ref.py``; a CUDA tensor
launches ``csrc/cascade_mlp.cu`` or raises. Each model's weights are packed
once per model object into the layout the kernels copy into shared memory
(see :func:`packed_chain`) and cached beside it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.mm_int8.ops import MAX_SHIFT, mm_int8
from repro_torch.quant import QuantizedMLP
from .ref import cascade_mlp_ref, deepsets_ref

MAX_LAYERS = 16                 # REPRO_MAX_LAYERS in csrc/int8_chain.cuh
BLOCK_ROWS = 64                 # rows a cascade_mlp block carries


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclasses.dataclass(frozen=True)
class PackedChain:
    """A layer chain in the kernels' layout, on the model's device.

    ``w``: every layer's w^T (N, ks) int8, K zero-padded to ``ks`` bytes
    (``ks / 4`` odd), each layer 16-byte aligned. ``b``: the int32 biases,
    padded to a multiple of 4. ``meta``: the host ints the C entry points
    read (see ``chain_from_meta`` in ``csrc/int8_chain.cuh``).
    """

    w: torch.Tensor
    b: torch.Tensor
    meta: ctypes.Array
    widths: Tuple[int, ...]     # K0, then every layer's N

    @property
    def smem_bytes(self) -> int:
        return self.w.numel() + 4 * self.b.numel()

    @property
    def stride(self) -> int:
        """Widest activation row in bytes, rounded so stride / 4 is odd."""
        return 4 * ((_round_up(max(self.widths), 4) // 4) | 1)


def _pack(qmlp: QuantizedMLP) -> PackedChain:
    layers = qmlp.layers
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{MAX_LAYERS} layers, "
                         f"got {len(layers)}")
    w_parts: List[np.ndarray] = []
    b_parts: List[np.ndarray] = []
    meta: List[int] = []
    w_off = b_off = 0
    widths = [layers[0].w_q.shape[0]]
    for l in layers:
        k, n = l.w_q.shape
        if k != widths[-1]:
            raise ValueError(f"layer widths do not chain: {widths[-1]} -> {k}")
        if not 0 <= l.shift <= MAX_SHIFT:
            raise ValueError(f"shift must be in 0..{MAX_SHIFT}, got {l.shift}")
        kp, np_ = _round_up(k, 4), _round_up(n, 4)
        ks = 4 * ((kp // 4) | 1)
        wt = np.zeros((n, ks), np.int8)
        wt[:, :k] = l.w_q.cpu().numpy().T
        flat = wt.reshape(-1)
        w_parts.append(np.pad(flat, (0, _round_up(flat.size, 16) - flat.size)))
        has_bias = l.bias_q is not None
        meta += [k, kp, ks, n, np_, l.shift, int(l.relu), int(has_bias),
                 w_off, b_off]
        w_off += w_parts[-1].size
        if has_bias:
            b_parts.append(l.bias_q.cpu().numpy().astype(np.int32))
            b_off += n
        widths.append(n)
    b = np.concatenate(b_parts) if b_parts else np.zeros(0, np.int32)
    b = np.pad(b, (0, _round_up(b.size, 4) - b.size))
    header = [len(layers), w_off, b.size]
    dev = qmlp.device
    return PackedChain(
        w=torch.from_numpy(np.concatenate(w_parts)).to(dev),
        b=torch.from_numpy(b).to(dev),
        meta=(ctypes.c_int * (len(header) + len(meta)))(*header, *meta),
        widths=tuple(widths))


_packed: "weakref.WeakKeyDictionary[QuantizedMLP, PackedChain]" = \
    weakref.WeakKeyDictionary()
_packed_lock = threading.Lock()


def packed_chain(qmlp: QuantizedMLP) -> PackedChain:
    """``qmlp`` packed for the kernels, built once per model object."""
    with _packed_lock:
        p = _packed.get(qmlp)
        if p is None:
            p = _packed[qmlp] = _pack(qmlp)
        return p


def prepare(*models: Optional[QuantizedMLP]) -> None:
    """Packs each model that lies on CUDA for the fused kernels now, so that
    its first launch does not pay for it. CPU models run the plain versions
    and need nothing; ``None`` is skipped."""
    for q in models:
        if q is not None and q.device.type == "cuda":
            packed_chain(q)


def _check_input(x: torch.Tensor, qmlp: QuantizedMLP, ndim: Tuple[int, ...]):
    if x.dtype != torch.int8 or x.dim() not in ndim:
        raise ValueError(f"x must be int8 with {ndim} dims, got {x.dtype} "
                         f"{tuple(x.shape)}")
    k0 = qmlp.layers[0].w_q.shape[0]
    if x.shape[-1] != k0:
        raise ValueError(f"x has {x.shape[-1]} features, the model takes {k0}")


def _check_smem(nbytes: int) -> None:
    if nbytes > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"the chain's working set is {nbytes} bytes, above one block's "
            f"{_build.MAX_SMEM_BYTES}: it cannot be fused into one kernel")


def cascade_mlp(x: torch.Tensor, qmlp: QuantizedMLP) -> torch.Tensor:
    """Fused MLP forward. x: (M, K0) int8 (any M/K0); returns (M, N_L) int8."""
    _check_input(x, qmlp, (2,))
    if _build.on_cpu(x, qmlp.layers[0].w_q):
        return cascade_mlp_ref(x, qmlp)
    _build.require_contiguous(x=x)
    pc = packed_chain(qmlp)
    stride = pc.stride
    smem = pc.smem_bytes + 2 * BLOCK_ROWS * stride
    _check_smem(smem)
    rows = x.shape[0]
    out = torch.empty((rows, pc.widths[-1]), dtype=torch.int8, device=x.device)
    if rows == 0:
        return out
    lib = _build.library()
    code = lib.cascade_mlp_launch(
        x.data_ptr(), pc.w.data_ptr(), pc.b.data_ptr(),
        ctypes.addressof(pc.meta), out.data_ptr(), rows, x.shape[1],
        BLOCK_ROWS, stride, smem, _build.stream_of(x))
    _build.check(code, "cascade_mlp")
    _build.launches.add("cascade_mlp")
    return out


def deepsets(x: torch.Tensor, phi: QuantizedMLP, rho: QuantizedMLP, *,
             agg: str = "mean") -> torch.Tensor:
    """Fully-fused DeepSets forward.

    x: (M, F) int8 -> (1, classes) int8, or (B, M, F) -> (B, 1, classes), one
    launch for the batch. The set is padded to a power of two Mp with zero
    rows *before* phi, and both 'mean' and 'sum' requantize the aggregate by
    log2(Mp) (``agg`` is accepted and, as in the TPU kernel, changes
    nothing); the padded rows therefore add phi(0) to it.
    """
    if agg not in ("mean", "sum"):
        raise ValueError(f"agg must be 'mean' or 'sum', got {agg!r}")
    _check_input(x, phi, (2, 3))
    if rho.layers[0].w_q.shape[0] != phi.layers[-1].w_q.shape[1]:
        raise ValueError("rho's input width differs from phi's output width")
    squeeze = x.dim() == 2
    xb = x[None] if squeeze else x
    batch, m, f = xb.shape
    if m == 0:
        raise ValueError("deepsets needs at least one set element")
    mp = 1 << (m - 1).bit_length()
    if _build.on_cpu(xb, phi.layers[0].w_q, rho.layers[0].w_q):
        out = deepsets_ref(F.pad(xb, (0, 0, 0, mp - m)), phi, rho, agg=agg)
    else:
        out = _launch_deepsets(xb, phi, rho, batch, m, mp, f)
    return out[0] if squeeze else out


def _launch_deepsets(x, phi, rho, batch, m, mp, f):
    _build.require_contiguous(x=x)
    pp, pr = packed_chain(phi), packed_chain(rho)
    stride = max(pp.stride, pr.stride)
    smem = pp.smem_bytes + pr.smem_bytes + 2 * mp * stride
    _check_smem(smem)
    n_out = pr.widths[-1]
    out = torch.empty((batch, 1, n_out), dtype=torch.int8, device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    code = lib.deepsets_launch(
        x.data_ptr(), pp.w.data_ptr(), pp.b.data_ptr(),
        ctypes.addressof(pp.meta), pr.w.data_ptr(), pr.b.data_ptr(),
        ctypes.addressof(pr.meta), out.data_ptr(), batch, m, mp, f,
        mp.bit_length() - 1, stride, smem, _build.stream_of(x))
    _build.check(code, "deepsets")
    _build.launches.add("deepsets")
    return out


def mlp_unfused(x: torch.Tensor, qmlp: QuantizedMLP) -> torch.Tensor:
    """Per-layer baseline: one mm_int8 call per layer, the activations going
    out to device memory and back between launches (the DMA-mode analogue)."""
    a = x
    for l in qmlp.layers:
        a = mm_int8(a, l.w_q, l.bias_q, shift=l.shift, relu=l.relu)
    return a
