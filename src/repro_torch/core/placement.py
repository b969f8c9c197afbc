"""Placement of mapped layers onto the physical AIE grid (paper §5.2).

Each layer occupies a rectangle of ``(A*C) rows x B cols``. Layers are placed
sequentially (left-to-right, bottom-to-top): for each layer we scan candidate
bottom-left anchors in (row, col) order and take the first free rectangle —
"the bottom-left tile with the minimum row index, and among such candidates,
the minimum column index".

The placement determines
  * whether consecutive layers are *adjacent east* (cascade-eligible), and
  * the Manhattan distance D used in the DMA latency model (Eq. 5 uses the
    longest distance among communicating pairs).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from . import aie_arch
from .mapping import Mapping, ModelMapping, cascade_compatible


@dataclasses.dataclass(frozen=True)
class Rect:
    """Placed rectangle: rows [r0, r0+h), cols [c0, c0+w)."""

    r0: int
    c0: int
    h: int
    w: int

    @property
    def r1(self) -> int:
        return self.r0 + self.h

    @property
    def c1(self) -> int:
        return self.c0 + self.w

    def overlaps(self, other: "Rect") -> bool:
        return not (self.r1 <= other.r0 or other.r1 <= self.r0
                    or self.c1 <= other.c0 or other.c1 <= self.c0)

    def tiles(self) -> List[Tuple[int, int]]:
        return [(r, c) for r in range(self.r0, self.r1)
                for c in range(self.c0, self.c1)]

    def translated(self, dr: int, dc: int) -> "Rect":
        return Rect(self.r0 + dr, self.c0 + dc, self.h, self.w)


def east_adjacent(prev: Rect, nxt: Rect, *, exact_rows: bool = True) -> bool:
    """True when ``nxt`` starts in the column immediately east of ``prev``.

    ``exact_rows`` demands the same row span (Fig. 6 MM-to-MM cascade);
    aggregation edges only need overlapping rows (§4.3.1 places the agg
    column adjacent to the producer; the 1 x F result streams onward from
    a single tile).
    """
    if nxt.c0 != prev.c1:
        return False
    if exact_rows:
        return nxt.r0 == prev.r0 and nxt.h == prev.h
    return not (nxt.r1 <= prev.r0 or prev.r1 <= nxt.r0)


def max_manhattan(prev: Rect, nxt: Rect) -> int:
    """Longest Manhattan distance between any producer tile (rightmost column
    of ``prev``, where full results live — Fig. 4d) and any consumer tile."""
    d = 0
    src_c = prev.c1 - 1
    for sr in range(prev.r0, prev.r1):
        for dr in range(nxt.r0, nxt.r1):
            for dc in range(nxt.c0, nxt.c1):
                d = max(d, abs(sr - dr) + abs(src_c - dc))
    return d


@dataclasses.dataclass(frozen=True)
class Placement:
    """Physical placement for every layer of a ModelMapping."""

    model_mapping: ModelMapping
    rects: Tuple[Rect, ...]

    def cascade_links(self) -> List[bool]:
        """For each inter-layer edge i -> i+1: is the cascade connection used?

        Requires mapping compatibility (A=A', C=C'=1) *and* east adjacency.
        Aggregation layers use the shared-memory connection from their
        producer (paper §4.3.1) which also requires adjacency.
        """
        mm = self.model_mapping.mappings
        links = []
        for i in range(len(mm) - 1):
            agg_edge = (mm[i].layer.kind == "agg"
                        or mm[i + 1].layer.kind == "agg")
            ok = (cascade_compatible(mm[i], mm[i + 1])
                  and east_adjacent(self.rects[i], self.rects[i + 1],
                                    exact_rows=not agg_edge))
            links.append(ok)
        return links

    def dma_distances(self) -> List[int]:
        """Longest Manhattan distance per inter-layer edge (for Eq. 5)."""
        return [max_manhattan(self.rects[i], self.rects[i + 1])
                for i in range(len(self.rects) - 1)]

    def bounding_box(self) -> Rect:
        """Tightest rectangle enclosing every layer rect."""
        r0 = min(r.r0 for r in self.rects)
        c0 = min(r.c0 for r in self.rects)
        r1 = max(r.r1 for r in self.rects)
        c1 = max(r.c1 for r in self.rects)
        return Rect(r0, c0, r1 - r0, c1 - c0)

    def shim_columns(self) -> Tuple[int, ...]:
        """Array-interface columns this design loads/stores through.

        PLIO enters the array through the shim DMA of the columns under the
        design's bounding box; co-resident tenants whose boxes stack
        vertically therefore *share* these columns — the contention the
        Tier-S simulator and the tenancy ingest penalty model serialize.
        """
        box = self.bounding_box()
        return tuple(range(box.c0, box.c1))

    def translated(self, dr: int, dc: int) -> "Placement":
        """Rigid translation of the whole design on the grid.

        Adjacency (hence cascade links) and all pairwise Manhattan distances
        are translation-invariant, so the Tier-A latency of the translated
        placement is identical — this is what lets the multi-tenant packer
        (not ported yet) move whole instances around freely.
        """
        return Placement(model_mapping=self.model_mapping,
                         rects=tuple(r.translated(dr, dc) for r in self.rects))


def rect_is_free(occ: List[List[bool]], r0: int, c0: int, h: int,
                 w: int) -> bool:
    """Is the h x w rectangle anchored at (r0, c0) in bounds and unoccupied?"""
    rows, cols = len(occ), len(occ[0])
    if r0 + h > rows or c0 + w > cols:
        return False
    return all(not occ[r][c] for r in range(r0, r0 + h)
               for c in range(c0, c0 + w))


def find_free_anchor(occ: List[List[bool]], h: int,
                     w: int) -> Optional[Tuple[int, int]]:
    """Bottom-left first-fit: the free anchor with the minimum row index,
    then minimum column index (paper §5.2). Shared by the intra-model
    layer placement here and the multi-tenant packer.
    """
    for r0 in range(len(occ)):
        for c0 in range(len(occ[0])):
            if rect_is_free(occ, r0, c0, h, w):
                return (r0, c0)
    return None


def mark_occupied(occ: List[List[bool]], rect: Rect) -> None:
    for r, c in rect.tiles():
        occ[r][c] = True


def place(model_mapping: ModelMapping,
          rows: int = aie_arch.ARRAY_ROWS,
          cols: int = aie_arch.ARRAY_COLS) -> Optional[Placement]:
    """Bottom-left sequential placement (paper §5.2 / Fig. 8c).

    For cascade-compatible consecutive layers we first try the east-adjacent
    anchor (so that compatibility in mapping translates into an actual
    cascade link, as in the paper's L2/L3 example); otherwise we fall back
    to the generic bottom-left scan. Returns None if anything does not fit.
    """
    placed: List[Rect] = []
    occ = [[False] * cols for _ in range(rows)]

    mappings = model_mapping.mappings
    for i, m in enumerate(mappings):
        h, w = m.rows, m.cols
        anchor: Optional[Rect] = None
        # Preferred: east-adjacent to the previous layer when cascade-legal.
        if placed and cascade_compatible(mappings[i - 1], m):
            prev = placed[-1]
            if prev.h == h and rect_is_free(occ, prev.r0, prev.c1, h, w):
                anchor = Rect(prev.r0, prev.c1, h, w)
        if anchor is None:
            at = find_free_anchor(occ, h, w)
            if at is not None:
                anchor = Rect(at[0], at[1], h, w)
        if anchor is None:
            return None
        mark_occupied(occ, anchor)
        placed.append(anchor)
    return Placement(model_mapping=model_mapping, rects=tuple(placed))
