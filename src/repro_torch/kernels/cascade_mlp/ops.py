"""Public wrappers of the fused cascade MLP (K2) and DeepSets (K3) kernels.

A CPU tensor goes to the plain versions in ``ref.py``; a CUDA tensor
launches ``csrc/cascade_mlp.cu`` or raises. Each model's weights are packed
once per model object, by :func:`packed_mma_chain`, into the tensor-core
fragment layout that both kernels copy into shared memory, and cached
beside it.

A launch goes through a launch plan, built once per K2 model (at
:func:`prepare` or its first call) and once per K3 (phi, rho) pair (its
first call): the packed tensors, the chains decoded on the C side, the
shared-memory sizes checked against one block's, the kernel's limit of
shared memory raised, the device. A call whose plan is built checks x
(dtype, dims, width, layout, device), allocates the output and makes one
short C call with x, the output, x's rows (K2) or batch and set size (K3)
and the calling thread's current stream; the C side derives the rest.
Anything else (a CPU tensor, a model elsewhere, a first call) runs the full
checks, and a CPU call the plain version. ``kernels._build.plans`` counts
the plans built.

While a ``torch.profiler`` records, ``_build.spans`` times each call in
flat phases, each a profiler range: ``repro_torch.checks`` (the input
checks), ``repro_torch.pack`` (the plan's lookup), ``repro_torch.alloc``
(the output) and ``repro_torch.launch`` (the stream, the C entry point,
the count). A CPU call's plain version runs after its checks, in no phase.
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
BLOCK_ROWS = 32                 # rows a cascade_mlp block carries: two warps
                                # of 16, so a 4096-row batch fills 128 SMs
EVENT_WARPS = 2                 # warps a deepsets event spans, each taking
WARP_ROWS = 16                  # 16 of every 32 set rows (kEventWarps)
EVENTS_PER_BLOCK = 2            # events a deepsets block holds


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclasses.dataclass(frozen=True)
class PackedChain:
    """A layer chain in the kernels' layout, on the model's device.

    ``w``: every layer's w^T int8 (N8, ks), N zero-padded to N8 = a
    multiple of 8 and K to kp = a multiple of 32, ``ks = kp + 16``, each
    layer 16-byte aligned. ``b``: the int32 biases, each zero-padded to N8,
    the whole padded to a multiple of 4. ``meta``: the host ints the C entry
    points read (see ``chain_from_meta`` in ``csrc/int8_chain.cuh``).
    ``stride`` is the activation row in bytes, the widest kp plus 16 (so
    ``stride / 4`` = 4 mod 8: a fragment load hits 32 distinct banks).
    """

    w: torch.Tensor
    b: torch.Tensor
    meta: ctypes.Array
    widths: Tuple[int, ...]     # K0, then every layer's N
    stride: int

    @property
    def smem_bytes(self) -> int:
        return self.w.numel() + 4 * self.b.numel()


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
        kp, np_ = _round_up(k, 32), _round_up(n, 8)
        ks = kp + 16
        wt = np.zeros((np_, ks), np.int8)
        wt[:n, :k] = l.w_q.cpu().numpy().T
        flat = wt.reshape(-1)
        w_parts.append(np.pad(flat, (0, _round_up(flat.size, 16) - flat.size)))
        has_bias = l.bias_q is not None
        meta += [k, kp, ks, n, np_, l.shift, int(l.relu), int(has_bias),
                 w_off, b_off]
        w_off += w_parts[-1].size
        if has_bias:
            bias = l.bias_q.cpu().numpy().astype(np.int32)
            b_parts.append(np.pad(bias, (0, np_ - n)))
            b_off += b_parts[-1].size
        widths.append(n)
    b = np.concatenate(b_parts) if b_parts else np.zeros(0, np.int32)
    b = np.pad(b, (0, _round_up(b.size, 4) - b.size))
    header = [len(layers), w_off, b.size]
    stride = _round_up(max(widths[:-1]), 32) + 16
    dev = qmlp.device
    return PackedChain(
        w=torch.from_numpy(np.concatenate(w_parts)).to(dev),
        b=torch.from_numpy(b).to(dev),
        meta=(ctypes.c_int * (len(header) + len(meta)))(*header, *meta),
        widths=tuple(widths), stride=stride)


_packed: "weakref.WeakKeyDictionary[QuantizedMLP, PackedChain]" = \
    weakref.WeakKeyDictionary()
_packed_lock = threading.Lock()


def packed_mma_chain(qmlp: QuantizedMLP) -> PackedChain:
    """``qmlp`` packed for the kernels' tensor-core fragments, once per model
    object."""
    with _packed_lock:
        p = _packed.get(qmlp)
        if p is None:
            p = _packed[qmlp] = _pack(qmlp)
        return p


def _deepsets_pack(phi: QuantizedMLP, rho: QuantizedMLP) -> torch.Tensor:
    """phi's and rho's weights, biases and layer records (the ints of
    ``meta`` after its header) back to back, each a multiple of 16 bytes, one
    uint8 tensor on their device: K3 copies it in one loop."""
    pp, pr = packed_mma_chain(phi), packed_mma_chain(rho)
    records = []
    for pc in (pp, pr):
        r = np.array(pc.meta[3:], np.int32)
        records.append(torch.from_numpy(
            np.pad(r, (0, _round_up(r.size, 4) - r.size))).to(pc.w.device))
    return torch.cat([t.view(torch.uint8)
                      for t in (pp.w, pr.w, pp.b, pr.b, *records)])


def _cascade_smem(pc: PackedChain) -> int:
    """K2's shared memory: the weights, the biases, and each warp's two
    16-row activation buffers."""
    return pc.smem_bytes + 2 * BLOCK_ROWS * pc.stride


@dataclasses.dataclass(frozen=True)
class DeepsetsLayout:
    """K3's shared memory for a (phi, rho) pair, laid out as deepsets_kernel
    lays it out: the packed pair (``pack_bytes``: weights, biases, layer
    records), then per warp (``per_warp`` bytes) two activation buffers of
    WARP_ROWS rows of ``stride`` bytes, two staged copies of its rows of x
    (``xraw`` bytes each, with room for a word read past the last) and its
    int32 share of the set sum. Nothing grows with the set size; a block
    holds at most ``events`` events, and the C side asks for ``pack_bytes +
    events * EVENT_WARPS * per_warp`` bytes at a launch's own event count."""

    stride: int
    xraw: int
    per_warp: int
    pack_bytes: int
    events: int


def _deepsets_layout(pp: PackedChain, pr: PackedChain,
                     pack_bytes: int) -> DeepsetsLayout:
    stride = max(pp.stride, pr.stride)
    xraw = _round_up(WARP_ROWS * pp.widths[0] + 36, 16)
    per_warp = (2 * WARP_ROWS * stride + 2 * xraw
                + 4 * _round_up(pp.widths[-1], 8))
    _check_smem(pack_bytes + EVENT_WARPS * per_warp)
    events = min(EVENTS_PER_BLOCK, (_build.MAX_SMEM_BYTES - pack_bytes)
                 // (EVENT_WARPS * per_warp))
    return DeepsetsLayout(stride, xraw, per_warp, pack_bytes, events)


class _Plan:
    """A launch plan: what a launch needs that depends only on the model (K2)
    or the (phi, rho) pair (K3) and its device, built once. ``handle`` is the
    C side's plan (the decoded chains, the shared-memory sizes, the limit of
    shared memory raised); ``keep`` the packed tensors it points into. The
    handle is freed when the plan dies, with the model (phi) that keys it or
    when another rho replaces it."""

    def __init__(self, kernel: str, handle: int, device: int, k0: int,
                 n_out: int, keep, rho: Optional[QuantizedMLP] = None):
        lib = _build.library()
        self.launch = getattr(lib, kernel + "_plan_launch")
        self.handle = handle
        self.device = device
        self.k0 = k0
        self.n_out = n_out
        self.keep = keep
        self.rho = None if rho is None else weakref.ref(rho)
        self.freed = weakref.finalize(self, getattr(lib, kernel + "_plan_free"),
                                      handle)


def _new_plan(kernel: str, *args) -> int:
    """Calls ``<kernel>_plan_new(*args, &plan)``; the plan's handle."""
    handle = ctypes.c_void_p()
    code = getattr(_build.library(), kernel + "_plan_new")(
        *args, ctypes.addressof(handle))
    _build.check(code, kernel + "_plan_new")
    return handle.value


# model -> its K2 plan; phi -> the K3 plan of (phi, the rho it holds a weak
# reference to). Read without a lock; built under _plan_lock.
_k2_plans: "weakref.WeakKeyDictionary[QuantizedMLP, _Plan]" = \
    weakref.WeakKeyDictionary()
_k3_plans: "weakref.WeakKeyDictionary[QuantizedMLP, _Plan]" = \
    weakref.WeakKeyDictionary()
_plan_lock = threading.Lock()


def _cascade_plan(qmlp: QuantizedMLP) -> _Plan:
    """``qmlp``'s K2 plan, built at its first use; ``qmlp`` lies on CUDA."""
    with _plan_lock:
        plan = _k2_plans.get(qmlp)
        if plan is None:
            pc = packed_mma_chain(qmlp)
            smem = _cascade_smem(pc)
            _check_smem(smem)
            dev = pc.w.get_device()
            handle = _new_plan(
                "cascade_mlp", pc.w.data_ptr(), pc.b.data_ptr(),
                ctypes.addressof(pc.meta), pc.widths[0], BLOCK_ROWS,
                pc.stride, smem, dev)
            plan = _k2_plans[qmlp] = _Plan("cascade_mlp", handle, dev,
                                           pc.widths[0], pc.widths[-1], pc)
            _build.plans.add("cascade_mlp")
        return plan


def _deepsets_plan(phi: QuantizedMLP, rho: QuantizedMLP) -> _Plan:
    """The K3 plan of (phi, rho), built at the pair's first use; both lie on
    one CUDA device and rho takes phi's output width."""
    with _plan_lock:
        plan = _k3_plans.get(phi)
        if plan is None or plan.rho() is not rho:
            pp, pr = packed_mma_chain(phi), packed_mma_chain(rho)
            pack = _deepsets_pack(phi, rho)
            lay = _deepsets_layout(pp, pr, pack.numel())
            dev = pack.get_device()
            handle = _new_plan(
                "deepsets", pack.data_ptr(), lay.pack_bytes,
                ctypes.addressof(pp.meta), ctypes.addressof(pr.meta),
                pp.widths[0], lay.stride, lay.xraw, lay.per_warp, lay.events,
                dev)
            plan = _k3_plans[phi] = _Plan("deepsets", handle, dev,
                                          pp.widths[0], pr.widths[-1], pack,
                                          rho)
            _build.plans.add("deepsets")
        return plan


def prepare(*models: Optional[QuantizedMLP]) -> None:
    """Builds the K2 plan (its packing included) of each model that lies on
    CUDA now, so that its first launch does not pay for it. CPU models run
    the plain versions and need nothing; ``None`` is skipped."""
    for q in models:
        if q is not None and q.device.type == "cuda":
            _cascade_plan(q)


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


def _cascade_checks(x: torch.Tensor, qmlp: QuantizedMLP) -> bool:
    """A K2 call's checks; True where the plain version runs."""
    _check_input(x, qmlp, (2,))
    return _build.on_cpu(x, qmlp.layers[0].w_q)


def cascade_mlp(x: torch.Tensor, qmlp: QuantizedMLP) -> torch.Tensor:
    """Fused MLP forward. x: (M, K0) int8 (any M/K0); returns (M, N_L) int8."""
    span = _build.spans.begin("repro_torch.checks")
    try:
        dev = x.get_device()
        if not (dev >= 0 and x.dtype is torch.int8 and x.dim() == 2
                and x.is_contiguous()):
            if _cascade_checks(x, qmlp):
                if span is not None:
                    span.phase(None)
                return cascade_mlp_ref(x, qmlp)
            _build.require_contiguous(x=x)
        if span is not None:
            span.phase("repro_torch.pack")
        plan = _k2_plans.get(qmlp)
        if plan is None or plan.device != dev or x.shape[1] != plan.k0:
            _cascade_checks(x, qmlp)
            plan = _cascade_plan(qmlp)
        rows = x.shape[0]
        if span is not None:
            span.phase("repro_torch.alloc")
        out = torch.empty((rows, plan.n_out), dtype=torch.int8,
                          device=x.device)
        if rows == 0:
            return out
        if span is not None:
            span.phase("repro_torch.launch")
        code = plan.launch(plan.handle, x.data_ptr(), out.data_ptr(), rows,
                           _build.stream_of(x))
        _build.check(code, "cascade_mlp")
        _build.launches.add("cascade_mlp")
        return out
    finally:
        if span is not None:
            span.end()


def _deepsets_checks(x: torch.Tensor, phi: QuantizedMLP,
                     rho: QuantizedMLP) -> bool:
    """A K3 call's checks but ``agg``'s; True where the plain version
    runs."""
    _check_input(x, phi, (2, 3))
    if rho.layers[0].w_q.shape[0] != phi.layers[-1].w_q.shape[1]:
        raise ValueError("rho's input width differs from phi's output width")
    if x.shape[-2] == 0:
        raise ValueError("deepsets needs at least one set element")
    return _build.on_cpu(x, phi.layers[0].w_q, rho.layers[0].w_q)


def deepsets(x: torch.Tensor, phi: QuantizedMLP, rho: QuantizedMLP, *,
             agg: str = "mean") -> torch.Tensor:
    """Fully-fused DeepSets forward.

    x: (M, F) int8 -> (1, classes) int8, or (B, M, F) -> (B, 1, classes), one
    launch for the batch. The set is padded to a power of two Mp with zero
    rows *before* phi, and both 'mean' and 'sum' requantize the aggregate by
    log2(Mp) (``agg`` is accepted and, as in the TPU kernel, changes
    nothing); the padded rows therefore add phi(0) to it.
    """
    span = _build.spans.begin("repro_torch.checks")
    try:
        if agg not in ("mean", "sum"):
            raise ValueError(f"agg must be 'mean' or 'sum', got {agg!r}")
        dev = x.get_device()
        nd = x.dim()
        if not (dev >= 0 and x.dtype is torch.int8 and 2 <= nd <= 3
                and x.shape[-2] > 0 and x.is_contiguous()):
            if _deepsets_checks(x, phi, rho):
                if span is not None:
                    span.phase(None)
                xb = x[None] if nd == 2 else x
                m = xb.shape[1]
                mp = 1 << (m - 1).bit_length()
                out = deepsets_ref(F.pad(xb, (0, 0, 0, mp - m)), phi, rho,
                                   agg=agg)
                return out[0] if nd == 2 else out
            _build.require_contiguous(x=x)
        if span is not None:
            span.phase("repro_torch.pack")
        plan = _k3_plans.get(phi)
        if (plan is None or plan.rho() is not rho or plan.device != dev
                or x.shape[-1] != plan.k0):
            _deepsets_checks(x, phi, rho)
            plan = _deepsets_plan(phi, rho)
        if nd == 3:
            batch, m = x.shape[0], x.shape[1]
            shape = (batch, 1, plan.n_out)
        else:
            batch, m = 1, x.shape[0]
            shape = (1, plan.n_out)
        if span is not None:
            span.phase("repro_torch.alloc")
        out = torch.empty(shape, dtype=torch.int8, device=x.device)
        if batch == 0:
            return out
        if span is not None:
            span.phase("repro_torch.launch")
        code = plan.launch(plan.handle, x.data_ptr(), out.data_ptr(), batch,
                           m, _build.stream_of(x))
        _build.check(code, "deepsets")
        _build.launches.add("deepsets")
        return out
    finally:
        if span is not None:
            span.end()


def mlp_unfused(x: torch.Tensor, qmlp: QuantizedMLP) -> torch.Tensor:
    """Per-layer baseline: one mm_int8 call per layer, the activations going
    out to device memory and back between launches (the DMA-mode analogue)."""
    a = x
    for l in qmlp.layers:
        a = mm_int8(a, l.w_q, l.bias_q, shift=l.shift, relu=l.relu)
    return a
