"""AIE-ML (Versal VEK280) architecture constants and calibrated overheads.

This module is the single source of truth for the Tier-A (paper-faithful)
analytical model. All quantities are in AIE cycles unless suffixed otherwise;
the VEK280 AIE array runs at 1.25 GHz, i.e. 0.8 ns / cycle.

The *structural* constants (block shapes, bandwidths, grid size) come straight
from the paper / AIE-ML ISA documentation. The *overhead* constants (pipeline
epilogue, non-pipelined launch overhead, DMA init, cascade gap, ...) are
calibrated against the paper's measured Table 2 / Table 4 numbers by
:mod:`repro_torch.core.perfmodel` — see ``calibrate()`` there; the fitted values are
frozen here so that every consumer (DSE, benchmarks, tests) sees one model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Structural constants (paper §3, §4, §6.1)
# ---------------------------------------------------------------------------

AIE_FREQ_GHZ: float = 1.25          #: AIE array clock (Vitis 2024.1 default used in the paper)
NS_PER_CYCLE: float = 1.0 / AIE_FREQ_GHZ
PL_FREQ_MHZ: float = 330.0          #: FPGA-fabric clock used by the paper's PL shims

#: VEK280 AIE-ML array: 8 rows x 38 columns = 304 tiles.
ARRAY_ROWS: int = 8
ARRAY_COLS: int = 38
NUM_TILES: int = ARRAY_ROWS * ARRAY_COLS

#: Number of PLIO ports available to stream between PL and the AIE array.
#: The paper constrains A_1*B_1 + A_n*C_n <= P. The VEK280 array interface
#: exposes ~2 streams per shim column; the paper's own 128^3 design point
#: (8x4x1 first layer = 32 load ports) implies P >= 40, so we use 64.
PLIO_PORTS: int = 64

#: Interconnect bandwidths, bits per AIE cycle (paper Fig. 1).
CASCADE_BITS_PER_CYCLE: int = 512
SHAREDMEM_BITS_PER_CYCLE: int = 256
DMA_BITS_PER_CYCLE: int = 32

#: MM micro-block B_M x B_K x B_N executed by one VMAC instruction, keyed by
#: operand bitwidth (paper §4.1: 4x8x8 for INT8 on AIE-ML => 256 MAC/cycle).
BLOCK_SHAPES: Dict[str, Tuple[int, int, int]] = {
    "int8": (4, 8, 8),
    "int16": (4, 4, 8),
    "bf16": (4, 8, 4),
}

#: MACs retired per cycle per AIE for INT8 (4*8*8).
MACS_PER_CYCLE_INT8: int = 256

#: Cascade FIFO geometry (paper §4.2.3): 512-bit wide, depth 4.
CASCADE_FIFO_DEPTH: int = 4

#: PLIO streams exposed per shim column (the array interface provides ~2
#: streams per column — see the PLIO_PORTS note above: 64 ports / 38 cols).
#: The shim DMA of a column is shared by every tenant whose bounding box
#: covers that column, which is what the contention model serializes.
SHIM_STREAMS_PER_COL: int = 2


# ---------------------------------------------------------------------------
# Calibrated overhead constants (fit by repro_torch.core.perfmodel.calibrate()
# against Table 2 / Table 4 measurements; values frozen from that fit).
# See EXPERIMENTS.md "Tier-A calibration" for the fit residuals.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OverheadParams:
    """Calibrated hardware-overhead parameters (cycles).

    Names follow the paper's Eq. (1)-(6) symbols where one exists.
    """

    # --- single-AIE MM kernel (Eq. 1-2) ---
    l_epi: float = 0.0            #: per-j-loop epilogue cycles (fit ~1e-4: the
                                  #: aiecompiler hides the drain in the II=1 pipe)
    l_o: float = 22.76            #: non-pipelined prologue/launch/sync overhead
    l_o_store_dma: float = 0.00955  #: extra L_o cycles per output element when
                                  #: the result is stored to local memory
                                  #: (cascade output skips the store, paper §5.1.1)

    # --- bias + ReLU epilogue (paper §4.3.2, Table 2 "+BR" columns) ---
    # Extra fixed cycles: max(0, br_w2*W2 + br_h1*H1 + br_fixed). Bias
    # load/duplicate scales with output columns, ReLU+requant with rows.
    br_w2: float = 0.9436
    br_h1: float = 1.6626
    br_fixed: float = -34.857

    # --- cascaded AIE array (Eq. 3-4) ---
    l_cas: float = 2.0            #: per-j-loop stall from cascade back-pressure
    o_cas: float = 9.0            #: Eq. 6 constant gap between producer/consumer
                                  #: compute phases when cascade inter-layer comm is used

    # --- DMA (Eq. 5) ---
    l_init: float = 70.0          #: DMA init + lock-synchronization latency
    dma_hop: float = 4.0          #: cycles per Manhattan-distance hop (paper: 4*D)

    # --- PLIO (array-edge streaming, used by first/last layer) ---
    plio_bits_per_cycle: int = 32 #: per-port PLIO stream width at AIE clock
    plio_init: float = 150.0      #: one-time PLIO/DMA setup before first beat

    # --- global aggregation kernels (Table 4 calibration) ---
    agg_fixed: float = -11.0      #: ours: fixed kernel overhead (net of VMACs)
    agg_per_aie: float = 22.813   #: ours: per-AIE shared-mem handoff + chain overhead
    agg_base_fixed: float = -125.625  #: baseline: fixed offset
    agg_base_per_aie: float = 15.3125  #: baseline: per-AIE overhead
    agg_base_per_elem: float = 2.0117  #: baseline: extract/add/insert cycles per element


#: The frozen, calibrated parameter set used across the repo.
OVERHEADS = OverheadParams()


def ns(cycles: float) -> float:
    """Convert AIE cycles to nanoseconds."""
    return cycles * NS_PER_CYCLE


def cycles_from_ns(t_ns: float) -> float:
    """Convert nanoseconds to AIE cycles."""
    return t_ns * AIE_FREQ_GHZ
