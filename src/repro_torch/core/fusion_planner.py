"""Shared-memory-constrained layer-fusion DSE (Tier B analogue of §5.2).

Decides which contiguous layers of a model fuse into one cascade kernel
(K2). The legality rule mirrors the paper's cascade constraint:

  AIE:   cascade legal iff  A = A', C = C' = 1, consumer placed east
  H100:  fusion legal iff   the chain's shared memory, as K2's wrapper
         counts it (:func:`repro_torch.core.h100_model.chain_smem_bytes`),
         fits one block's budget and the chain has at most K2's
         ``MAX_LAYERS`` layers

so the planner never plans a group K2 would refuse, nor refuses one it
would run. The objective is the overhead-aware end-to-end latency from
:mod:`repro_torch.core.h100_model` — launch + prologue + max(compute, HBM).

Optimal chain partitioning is an O(L^2) interval DP (the 1-D analogue of
the paper's brute-force mapping search; exact, not heuristic).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from . import h100_model
from .layerspec import ModelSpec
from .h100_model import LayerShape


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    groups: Tuple[Tuple[int, ...], ...]     #: layer indices per fused kernel
    time_s: float                           #: modeled end-to-end latency
    unfused_time_s: float                   #: per-layer baseline
    smem_budget: int

    @property
    def speedup(self) -> float:
        return self.unfused_time_s / self.time_s

    @property
    def n_kernels(self) -> int:
        return len(self.groups)


def shapes_from_model(model: ModelSpec,
                      bytes_per_elem: int = 1) -> List[LayerShape]:
    return [LayerShape(M=l.M, K=l.K, N=l.N, bytes_per_elem=bytes_per_elem,
                       bias=l.bias)
            for l in model.layers]


def plan(layers: Sequence[LayerShape], *,
         smem_budget: int = h100_model.SMEM_BUDGET) -> FusionPlan:
    """Interval DP: best[i] = min over j<=i of best[j-1] + cost(j..i) with
    cost defined only for chains K2 takes within the budget."""
    n = len(layers)
    INF = float("inf")
    best = [INF] * (n + 1)
    cut = [0] * (n + 1)
    best[0] = 0.0
    for i in range(1, n + 1):
        for j in range(i, 0, -1):
            chain = layers[j - 1:i]
            if (len(chain) > h100_model.MAX_CHAIN_LAYERS
                    or h100_model.chain_smem_bytes(chain) > smem_budget):
                break       # longer chains only grow; j decreasing adds layers
            t = best[j - 1] + h100_model.fused_chain_time_s(chain)
            if t < best[i]:
                best[i] = t
                cut[i] = j - 1
    if best[n] == INF:
        raise ValueError("a single layer exceeds the shared-memory budget; "
                         "split the layer before fusing")
    groups: List[Tuple[int, ...]] = []
    i = n
    while i > 0:
        j = cut[i]
        groups.append(tuple(range(j, i)))
        i = j
    groups.reverse()
    return FusionPlan(groups=tuple(groups), time_s=best[n],
                      unfused_time_s=h100_model.unfused_chain_time_s(layers),
                      smem_budget=smem_budget)
