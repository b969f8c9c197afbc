"""Overhead-aware H100 latency model (Tier B — the paper's Eq. 1-6 re-derived
for one NVIDIA H100 and the port's INT8 kernels).

The paper's thesis is that at microsecond scale, *overheads that throughput
frameworks ignore* (kernel prologue, synchronization, per-transfer init)
dominate. On the H100 the corresponding first-order terms are:

  =====================  ===============================================
  AIE-ML term            H100 term
  =====================  ===============================================
  VLIW prologue L_o      kernel launch (the launch floor in a CUDA graph)
  lock sync / L_init     the fused chain's fixed prologue: weights, biases
                         and input staged into shared memory by cp.async,
                         one block barrier
  per-layer L_comp       a latency chain of dependent mma.sync, epilogue
                         and __syncwarp per layer, which ``flops / peak``
                         would put at ~0
  DMA 32 b/cyc           HBM bandwidth 3.35 TB/s
  cascade 512 b/cyc      shared-memory residency (one CTA, 227 KB)
  PLIO                   host -> device copy of a served batch
  =====================  ===============================================

One kernel costs ``launch + fixed prologue + max(compute, HBM)``, where
compute is ``flops / peak`` plus the per-layer latency chain. The fused
chain pays the launch and the prologue once; the per-layer chain (K1 a
layer) pays a launch and K1's own fixed cost every layer.

What it covers: the device time of one chain, on its own, as
``chip_smoke.py`` times it in a CUDA graph. A served event today is 99.6%
host: 4.29 us of device time in a 1036 us p50 (deepsets-32, B = 1, ``PERF.md``
§5; NVIDIA H100 80GB HBM3, 700.00 W). The queue, the collection window and
the host's copies are outside this model; :func:`ingest_time_s` is the only
host-side term.

Used by :mod:`repro_torch.core.fusion_planner` (which layers to fuse into one
cascade kernel, K2) and by ``JetServer.modeled_latency_us``. The legality
rule is the one K2's wrapper applies (``kernels/cascade_mlp/ops.py``).

Constants: the peak rates are NVIDIA's data sheet (H100 SXM, dense, 700 W).
The rest are measured on the card by :func:`calibrate`, which
``chip_smoke.py``'s phase 7 runs, printing each one beside the value held
here, so a stale constant shows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cascade_mlp.ops import (BLOCK_ROWS, MAX_LAYERS,
                                                 cascade_mlp, deepsets)
from repro_torch.kernels.mm_int8.ops import mm_int8
from repro_torch.quant import QuantizedMLP, quantize_mlp

# ---------------------------------------------------------------------------
# Hardware constants — NVIDIA H100 SXM data sheet (dense, at 700 W)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS: float = 989e12        #: bf16 tensor cores, data sheet
PEAK_INT8_OPS: float = 1979e12         #: int8 tensor cores, data sheet
HBM_BW: float = 3.35e12                #: bytes/s, data sheet
HBM_BYTES: int = 80 * 10**9            #: device memory, data sheet (80 GB)
#: NVLink 4 between two H100 SXM cards, one direction: the data sheet's
#: 900 GB/s is both directions of 18 links. A one-card machine cannot
#: measure it; the dry run's collective term divides by it.
NVLINK_BW: float = 450e9
SMEM_BUDGET: int = _build.MAX_SMEM_BYTES   #: one block's shared memory, sm_90
MAX_CHAIN_LAYERS: int = MAX_LAYERS     #: the longest chain K2 takes

# ---------------------------------------------------------------------------
# Measured constants — by calibrate() in chip_smoke.py's phase 7
# (check_model), device times from CUDA graphs of 200 calls, all from one run
# on an NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi's name and power limit);
# PERF.md's H100-model section records that run
# ---------------------------------------------------------------------------

#: The launch floor: a 1-element ``zero_()`` a call.
KERNEL_LAUNCH_S: float = 1.0837e-6
#: K2's fixed prologue beyond the launch floor: the intercept of its time at
#: 2, 5 and 9 layers (jsc-m widths, 64 rows) minus the floor.
FUSED_PROLOGUE_S: float = 0.5790e-6
#: K2's time a layer: the slope of the same fit.
FUSED_LAYER_S: float = 0.9235e-6
#: K3's fixed prologue beyond the floor, for one event: the intercept of its
#: time at phi depths 2, 3 and 6 (width 32, rho 32-10, 32 x 21, B = 1) minus
#: the floor and rho's two layers.
SET_PROLOGUE_S: float = 1.2997e-6
#: K3's time a layer (phi or rho): the slope of the same fit.
SET_LAYER_S: float = 0.3673e-6
#: K1's fixed cost a layer beyond the floor: its mean time over jsc-m's five
#: layers at 64 rows minus the floor.
UNFUSED_LAYER_S: float = 1.5605e-6
#: Host -> device rate of one served batch (64 jsc-m events, 64 KiB, from
#: pageable memory as ``JetServer`` copies it): bytes over the copy's time.
HOST_INGRESS_BW: float = 2.8074e9

FUSED_KERNELS = ("cascade_mlp", "deepsets")
#: The constants :func:`calibrate` measures, in the order it prints them.
MEASURED = ("KERNEL_LAUNCH_S", "FUSED_PROLOGUE_S", "FUSED_LAYER_S",
            "SET_PROLOGUE_S", "SET_LAYER_S", "UNFUSED_LAYER_S",
            "HOST_INGRESS_BW")
#: The chains :func:`calibrate` times (64 rows; K3 one event of 32 x 21).
CAL_ROWS = 64
CAL_K2_CHAINS = ([16, 64, 5], [16, 64, 32, 32, 32, 5],
                 [16, 64] + [32] * 7 + [5])
CAL_K3_PHI_DEPTHS = (2, 3, 6)
CAL_K3_SET, CAL_K3_FEATURES, CAL_K3_RHO = 32, 21, (32, 10)
CAL_K1_CHAIN = [16, 64, 32, 32, 32, 5]


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """An MM layer viewed by the H100 model: M x K x N at a given bytewidth,
    with or without an int32 bias (which K2 keeps in shared memory)."""
    M: int
    K: int
    N: int
    bytes_per_elem: int = 1            # int8
    bias: bool = True

    @property
    def flops(self) -> int:
        return 2 * self.M * self.K * self.N

    @property
    def w_bytes(self) -> int:
        return self.K * self.N * self.bytes_per_elem

    @property
    def in_bytes(self) -> int:
        return self.M * self.K * self.bytes_per_elem

    @property
    def out_bytes(self) -> int:
        return self.M * self.N * self.bytes_per_elem


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def compute_time_s(flops: float, *, int8: bool = True, layers: int = 1,
                   layer_s: float = 0.0) -> float:
    """Tensor-core time at peak plus a latency chain of ``layers`` dependent
    layers of ``layer_s`` each (at these widths the chain is all of it)."""
    peak = PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS
    return flops / peak + layers * layer_s


def kernel_time_s(flops: float, hbm_bytes: float, *, int8: bool = True,
                  layers: int = 1, layer_s: float = 0.0,
                  prologue_s: float = 0.0) -> float:
    """One kernel launch: launch + fixed prologue + max(compute, HBM).

    Compute and HBM streaming overlap, so we take the max; the launch and
    the prologue serialize, which is the paper's point about L_init/L_o at
    the microsecond scale.
    """
    return (KERNEL_LAUNCH_S + prologue_s
            + max(compute_time_s(flops, int8=int8, layers=layers,
                                 layer_s=layer_s),
                  hbm_bytes / HBM_BW))


def fused_chain_time_s(layers: Sequence[LayerShape], *,
                       kernel: str = "cascade_mlp") -> float:
    """Fused (cascade-analogue) execution of a layer chain in ONE kernel:
    weights are staged once into shared memory, activations stay there; only
    the chain input, the final output and the weights cross HBM.
    ``kernel``: 'cascade_mlp' (K2) or 'deepsets' (K3, one event)."""
    if kernel == "cascade_mlp":
        prologue, layer = FUSED_PROLOGUE_S, FUSED_LAYER_S
    elif kernel == "deepsets":
        prologue, layer = SET_PROLOGUE_S, SET_LAYER_S
    else:
        raise ValueError(f"kernel must be one of {FUSED_KERNELS}, got "
                         f"{kernel!r}")
    flops = sum(l.flops for l in layers)
    return kernel_time_s(flops, hbm_traffic_bytes(layers, fused=True),
                         layers=len(layers), layer_s=layer,
                         prologue_s=prologue)


def unfused_chain_time_s(layers: Sequence[LayerShape]) -> float:
    """Per-layer execution (DMA-mode analogue, K1 a layer): every layer pays
    a launch and K1's fixed cost, and round-trips its activation through
    HBM."""
    t = 0.0
    for l in layers:
        hbm = l.in_bytes + l.w_bytes + l.out_bytes
        t += kernel_time_s(l.flops, hbm, layers=0,
                           prologue_s=UNFUSED_LAYER_S)
    return t


def chain_smem_bytes(layers: Sequence[LayerShape]) -> int:
    """Shared memory K2 asks for to run this chain, as its wrapper counts it
    (``packed_mma_chain(q).smem_bytes + 2 * BLOCK_ROWS * stride``): every
    layer's w^T with K padded to 32 (+16 bytes a row) and N to 8, each
    16-byte aligned; the int32 biases padded to N8, the whole to 4; and each
    warp's two activation buffers of the widest input row."""
    w = b = 0
    for l in layers:
        kp, n8 = _round_up(l.K, 32), _round_up(l.N, 8)
        w += _round_up(n8 * (kp + 16), 16)
        if l.bias:
            b += n8
    stride = _round_up(max(l.K for l in layers), 32) + 16
    return w + 4 * _round_up(b, 4) + 2 * BLOCK_ROWS * stride


def hbm_traffic_bytes(layers: Sequence[LayerShape],
                      fused: bool) -> int:
    """Total HBM bytes moved for one forward pass of the chain."""
    if fused:
        return (layers[0].in_bytes + layers[-1].out_bytes
                + sum(l.w_bytes for l in layers))
    return sum(l.in_bytes + l.w_bytes + l.out_bytes for l in layers)


def ingest_time_s(n_bytes: int) -> float:
    """Host -> device ingest (the PLIO analogue) for serving."""
    return n_bytes / HOST_INGRESS_BW


# ---------------------------------------------------------------------------
# Calibration on the card
# ---------------------------------------------------------------------------

def graph_time_s(fn: Callable[[], object], iters: int = 200) -> float:
    """Device time a call of ``fn``: ``iters`` calls captured once in a CUDA
    graph and replayed between two CUDA events (host overhead excluded)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / iters


def random_qmlp(rng: np.random.Generator, dims: Sequence[int],
                biases: Sequence[bool] = (), *, relu_last: bool = False,
                rows: int = 64) -> QuantizedMLP:
    """A quantized MLP of widths ``dims`` with random float weights,
    calibrated on random input (ReLU between layers); layer i has a bias
    unless ``biases[i]`` is False."""
    n = len(dims) - 1
    ws = [rng.normal(0, 0.4, (dims[i], dims[i + 1])) for i in range(n)]
    bs = [rng.normal(0, 0.1, (dims[i + 1],))
          if (biases[i] if biases else True) else None for i in range(n)]
    return quantize_mlp(ws, bs, [True] * (n - 1) + [relu_last],
                        rng.normal(0, 1, (rows, dims[0])))


def _fit(xs: Sequence[float], ts: Sequence[float]):
    """Least-squares line through (xs, ts): (intercept, slope)."""
    slope, intercept = np.polyfit(np.asarray(xs, float), np.asarray(ts), 1)
    return float(intercept), float(slope)


def calibrate(device="cuda", seed: int = 0) -> Dict[str, object]:
    """Measures every constant of :data:`MEASURED` on the card, as the
    constants' comments describe, from random weights made from ``seed``.

    Returns ``{"constants": {name: value}, "points": {...}}``, the points
    being the timings each fit was made from, in seconds. Raises without
    CUDA: it measures nothing elsewhere.
    """
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("calibrate() times kernels on a CUDA device")
    rng = np.random.default_rng(seed)

    z = torch.zeros(1, device=dev)
    floor = graph_time_s(lambda: z.zero_())

    k2 = {}
    x = torch.from_numpy(rng.integers(-128, 128, (CAL_ROWS, 16))
                         .astype(np.int8)).to(dev)
    for dims in CAL_K2_CHAINS:
        q = random_qmlp(rng, dims).to(dev)
        k2[len(dims) - 1] = graph_time_s(lambda: cascade_mlp(x, q))
    k2_a, k2_b = _fit(list(k2), list(k2.values()))

    k3 = {}
    xs = torch.from_numpy(rng.integers(
        -128, 128, (1, CAL_K3_SET, CAL_K3_FEATURES)).astype(np.int8)).to(dev)
    for d in CAL_K3_PHI_DEPTHS:
        phi = random_qmlp(rng, [CAL_K3_FEATURES] + [32] * d,
                          relu_last=True).to(dev)
        rho = random_qmlp(rng, [32, *CAL_K3_RHO]).to(dev)
        k3[d] = graph_time_s(lambda: deepsets(xs, phi, rho))
    k3_a, k3_b = _fit(list(k3), list(k3.values()))

    q = random_qmlp(rng, CAL_K1_CHAIN).to(dev)
    k1, a = [], x
    for l in q.layers:
        k1.append(graph_time_s(lambda: mm_int8(a, l.w_q, l.bias_q,
                                               shift=l.shift, relu=l.relu)))
        a = mm_int8(a, l.w_q, l.bias_q, shift=l.shift, relu=l.relu)

    # One served batch of 64 jsc-m events (64 x 64 x 16 int8) as JetServer
    # copies it: a pageable host array to the device, which a CUDA graph
    # cannot capture, so CUDA events around back-to-back copies.
    batch = rng.integers(-128, 128, (64, 64, 16)).astype(np.int8)
    copy = lambda: torch.from_numpy(batch).to(dev)
    for _ in range(10):
        copy()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        copy()
    end.record()
    end.synchronize()
    h2d = start.elapsed_time(end) * 1e-3 / 200

    n_rho = len(CAL_K3_RHO)
    constants = {
        "KERNEL_LAUNCH_S": floor,
        "FUSED_PROLOGUE_S": k2_a - floor,
        "FUSED_LAYER_S": k2_b,
        "SET_PROLOGUE_S": k3_a - floor - n_rho * k3_b,
        "SET_LAYER_S": k3_b,
        "UNFUSED_LAYER_S": float(np.mean(k1)) - floor,
        "HOST_INGRESS_BW": batch.nbytes / h2d,
    }
    return {"constants": constants,
            "points": {"launch_floor": floor, "cascade_mlp_by_layers": k2,
                       "deepsets_one_event_by_phi_layers": k3,
                       "mm_int8_by_layer": k1, "h2d_batch": h2d,
                       "h2d_batch_bytes": batch.nbytes}}
