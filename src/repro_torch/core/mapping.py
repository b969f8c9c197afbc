"""Spatial mapping of layers onto the AIE array (paper §4.1, §5.2).

A layer of shape ``M x K x N`` is partitioned ``A x B x C`` times along
M, K, N. The resulting AIE sub-array has ``A*C`` rows and ``B`` columns
(Fig. 4a): each row of B tiles accumulates partial sums along K via the
intra-layer cascade; the rightmost column holds full results (and runs the
fused bias/ReLU epilogue).

Per-AIE kernel shape: ``H1 = ceil(M/A)``, ``W1 = ceil(K/B)``, ``W2 = ceil(N/C)``.

Legality (paper §5.2):
  * A, B, C are powers of two;
  * H1 >= 2*B_M, W1 >= B_K, W2 >= 2*B_N so a single kernel has enough work
    (we allow the degenerate M < 2*B_M case with A=1 and padding, because the
    paper's own rho layers have M=1);
  * sum of tiles over all layers <= the array size;
  * PLIO budget: A_1*B_1 + A_n*C_n <= P (first-layer loads + last-layer stores).

Inter-layer cascade legality (paper §4.2.3): A == A' and C == C' == 1, and the
consumer placed directly east of the producer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Sequence, Tuple

from . import aie_arch
from .layerspec import LayerSpec, ModelSpec


def _pow2s(limit: int) -> List[int]:
    out, v = [], 1
    while v <= limit:
        out.append(v)
        v *= 2
    return out


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


@dataclasses.dataclass(frozen=True)
class Mapping:
    """Spatial parallelism (A, B, C) of one layer, with derived per-AIE shape."""

    A: int
    B: int
    C: int
    layer: LayerSpec
    dtype: str = "int8"

    @property
    def tiles(self) -> int:
        return self.A * self.B * self.C

    @property
    def rows(self) -> int:
        """Rows of the rectangular AIE region (Fig. 4a)."""
        return self.A * self.C

    @property
    def cols(self) -> int:
        return self.B

    # Per-AIE kernel shape, padded to the VMAC block grid so that the
    # performance model sees whole blocks (hardware pads identically).
    @property
    def block(self) -> Tuple[int, int, int]:
        return aie_arch.BLOCK_SHAPES[self.dtype]

    @property
    def H1(self) -> int:
        bm, _, _ = self.block
        return _round_up(_ceil_div(self.layer.M, self.A), 2 * bm)

    @property
    def W1(self) -> int:
        _, bk, _ = self.block
        return _round_up(_ceil_div(self.layer.K, self.B), bk)

    @property
    def W2(self) -> int:
        _, _, bn = self.block
        return _round_up(_ceil_div(self.layer.N, self.C), 2 * bn)

    @property
    def j_loops(self) -> int:
        """Number of j loops per kernel: H1*W2 / (4*B_M*B_N) (paper Eq. 1)."""
        bm, _, bn = self.block
        return max(1, (self.H1 * self.W2) // (4 * bm * bn))

    def legal(self) -> bool:
        bm, bk, bn = self.block
        l = self.layer
        if self.A > max(1, l.M // (2 * bm)) and self.A != 1:
            return False
        if self.B > max(1, l.K // bk) and self.B != 1:
            return False
        if self.C > max(1, l.N // (2 * bn)) and self.C != 1:
            return False
        return True


def enumerate_mappings(layer: LayerSpec, max_tiles: int,
                       dtype: str = "int8") -> Iterator[Mapping]:
    """All legal power-of-2 (A,B,C) mappings of ``layer`` within ``max_tiles``."""
    bm, bk, bn = aie_arch.BLOCK_SHAPES[dtype]
    if layer.kind == "agg":
        # Aggregation layer: one column of A tiles east of the producer
        # (paper §4.3.1); parallelism only along M.
        for a in _pow2s(min(max_tiles, max(1, layer.M // (2 * bm)))):
            m = Mapping(A=a, B=1, C=1, layer=layer, dtype=dtype)
            if m.rows <= aie_arch.ARRAY_ROWS:
                yield m
        return
    for a in _pow2s(max(1, layer.M // (2 * bm))):
        for b in _pow2s(max(1, layer.K // bk)):
            for c in _pow2s(max(1, layer.N // (2 * bn))):
                m = Mapping(A=a, B=b, C=c, layer=layer, dtype=dtype)
                if m.tiles > max_tiles:
                    continue
                if m.rows > aie_arch.ARRAY_ROWS or m.cols > aie_arch.ARRAY_COLS:
                    continue
                if m.legal():
                    yield m


def cascade_compatible(prev: Mapping, nxt: Mapping) -> bool:
    """Paper §4.2.3: inter-layer cascade needs A == A' and C == C' == 1.

    Aggregation edges follow §4.3.1: the linear layer feeding an aggregation
    must have C == 1 and the agg column mirrors its A (shared-local-memory
    handoff); the aggregated 1 x F vector cascades onward into any C == 1
    consumer (rho layers have M = 1, hence A' = 1).
    """
    if nxt.layer.kind == "agg":
        return prev.C == 1 and nxt.A == prev.A
    if prev.layer.kind == "agg":
        return nxt.C == 1
    return prev.A == nxt.A and prev.C == 1 and nxt.C == 1


@dataclasses.dataclass(frozen=True)
class ModelMapping:
    """A full mapping decision for every layer of a model."""

    model: ModelSpec
    mappings: Tuple[Mapping, ...]

    def __post_init__(self) -> None:
        if len(self.mappings) != self.model.num_layers:
            raise ValueError("one Mapping per layer required")

    @property
    def total_tiles(self) -> int:
        return sum(m.tiles for m in self.mappings)

    def plio_ports_needed(self) -> int:
        """Paper §5.2: A_1*B_1 loads + A_n*C_n stores must fit the PLIO budget."""
        first, last = self.mappings[0], self.mappings[-1]
        return first.A * first.B + last.A * last.C

    def fits(self, rows: int = aie_arch.ARRAY_ROWS,
             cols: int = aie_arch.ARRAY_COLS,
             plio: int = aie_arch.PLIO_PORTS) -> bool:
        return (self.total_tiles <= rows * cols
                and self.plio_ports_needed() <= plio)
