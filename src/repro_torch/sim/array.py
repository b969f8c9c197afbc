"""Physical resource model of the AIE array for the discrete-event simulator.

One :class:`Resource` per physical contention point:

  * **tiles** — 8 x 38 compute tiles, capacity 1. A legal schedule never
    queues on a tile (boxes are disjoint and layers of one event run in
    sequence); the recorded busy spans are what the "no tile double-booked"
    invariant checks.
  * **shim columns** — the PLIO ingest/egress DMA under each array column,
    capacity 1: transfers of co-resident tenants that share a column
    *serialize*, which is exactly the congestion the Tier-A model ignores.
  * **cascade/shared-memory FIFOs and DMA routes** — one resource per
    inter-layer edge per instance. Bounding-box isolation keeps routes of
    different tenants disjoint, so these never see cross-tenant queueing;
    they exist to own trace lanes and byte accounting.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import aie_arch

from .events import Resource


class ArrayResources:
    """Lazy registry of the array's physical resources (one sim run)."""

    def __init__(self, rows: int = aie_arch.ARRAY_ROWS,
                 cols: int = aie_arch.ARRAY_COLS, *,
                 shim_shared: bool = True) -> None:
        self.rows = rows
        self.cols = cols
        self.shim_shared = shim_shared
        self._tiles: Dict[Tuple[int, int], Resource] = {}
        self._shim: Dict[object, Resource] = {}
        self._edges: Dict[str, Resource] = {}

    def tile(self, r: int, c: int) -> Resource:
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise ValueError(f"tile ({r}, {c}) outside {self.rows}x{self.cols}")
        key = (r, c)
        if key not in self._tiles:
            self._tiles[key] = Resource(f"tile[{r},{c}]", pid="tiles",
                                        tid=f"r{r} c{c:02d}")
        return self._tiles[key]

    def shim(self, c: int, owner: str = "") -> Resource:
        """Shim-column PLIO resource. With ``shim_shared`` (the default) one
        capacity-1 resource per physical column — tenants sharing the column
        serialize (transfer durations already assume the column's full
        stream bandwidth, see ``tenancy.shim_transfer_cycles``, so one
        transfer at a time is the consistent capacity). ``shim_shared=False``
        gives each owner a private copy, which is the congestion-free
        counterfactual the contention report compares against.
        """
        if not 0 <= c < self.cols:
            raise ValueError(f"shim column {c} outside 0..{self.cols - 1}")
        key = c if self.shim_shared else (owner, c)
        if key not in self._shim:
            self._shim[key] = Resource(f"shim[{c}]", pid="shim",
                                       tid=f"col{c:02d}")
        return self._shim[key]

    def edge(self, name: str, kind: str) -> Resource:
        """Per-instance inter-layer link: kind is 'cascade' | 'sharedmem' | 'dma'."""
        pid = "dma" if kind == "dma" else "fifo"
        if name not in self._edges:
            self._edges[name] = Resource(name, pid=pid, tid=name)
        return self._edges[name]

    # -- invariant-check accessors ------------------------------------------
    def tile_resources(self) -> Dict[Tuple[int, int], Resource]:
        return dict(self._tiles)

    def shim_resources(self) -> Dict[object, Resource]:
        return dict(self._shim)

    def edge_resources(self) -> Dict[str, Resource]:
        return dict(self._edges)
