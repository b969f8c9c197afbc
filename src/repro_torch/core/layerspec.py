"""Layer/model IR for the Tier-A analytical pipeline.

The paper's supported model class (§5.2): a *sequence* of matrix-multiply
layers (optionally with fused bias+ReLU) with at most one global-aggregation
layer — i.e. MLPs and DeepSets. The IR here is deliberately tiny: it is the
input to the mapping/placement DSE and the performance model.

Shapes follow the paper's convention: an MM layer is ``M x K x N`` where M is
the row (set/batch) dimension, K the reduction dimension, and N the output
features. A global aggregation layer reduces M -> 1 over an ``M x F`` input.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the model, in the paper's M x K x N convention."""

    kind: str                 #: 'mm' or 'agg'
    M: int
    K: int
    N: int
    bias: bool = False
    relu: bool = False
    agg_op: str = "sum"       #: for kind == 'agg': 'sum' or 'mean'
    name: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ("mm", "agg"):
            raise ValueError(f"unknown layer kind {self.kind!r}")
        if self.kind == "agg" and (self.bias or self.relu):
            raise ValueError("aggregation layers take no bias/relu")
        if min(self.M, self.K, self.N) < 1:
            raise ValueError(f"bad layer shape {self.M}x{self.K}x{self.N}")

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def out_bytes(self) -> int:
        """INT8 output activation size in bytes."""
        return self.M * self.N if self.kind == "mm" else self.N

    @property
    def in_bytes(self) -> int:
        return self.M * self.K


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """An ordered chain of layers (MLP or DeepSets)."""

    layers: Tuple[LayerSpec, ...]
    name: str = "model"

    def __post_init__(self) -> None:
        n_agg = sum(1 for l in self.layers if l.kind == "agg")
        if n_agg > 1:
            raise ValueError("at most one global aggregation layer (paper §5.2)")
        # Shape chaining: layer i's N must equal layer i+1's K, and an agg
        # layer collapses M -> 1 for everything after it.
        for prev, nxt in zip(self.layers, self.layers[1:]):
            if prev.kind == "mm" and nxt.K != prev.N:
                raise ValueError(
                    f"layer chain mismatch: {prev.name} N={prev.N} -> {nxt.name} K={nxt.K}")
            if prev.kind == "agg" and nxt.M != 1:
                raise ValueError("layers after global aggregation must have M=1")

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers if l.kind == "mm")


def mlp(M: int, in_features: int, nodes: Sequence[int], *,
        bias: bool = True, relu: bool = True, name: str = "mlp") -> ModelSpec:
    """Build an MLP ModelSpec like the paper's JSC workloads.

    ``nodes`` is the per-layer width list, e.g. JSC-M = [64, 32, 32, 32, 5]
    on a 64 x 16 input. ReLU is applied to every layer but the last (the
    final classifier layer keeps bias only), matching hls4ml JSC models.
    """
    layers: List[LayerSpec] = []
    k = in_features
    for i, n in enumerate(nodes):
        last = i == len(nodes) - 1
        layers.append(LayerSpec(
            kind="mm", M=M, K=k, N=n, bias=bias, relu=relu and not last,
            name=f"{name}.l{i}"))
        k = n
    return ModelSpec(tuple(layers), name=name)


def synthetic_mlp(size: int, num_layers: int, *, bias_relu: bool = False,
                  name: Optional[str] = None) -> ModelSpec:
    """Paper Fig. 10 synthetic workloads: ``num_layers`` square s x s x s MMs."""
    layers = tuple(
        LayerSpec(kind="mm", M=size, K=size, N=size, bias=bias_relu,
                  relu=bias_relu, name=f"l{i}")
        for i in range(num_layers))
    return ModelSpec(layers, name=name or f"{size}^3L{num_layers}")


def deepsets(M: int, in_features: int, phi: Sequence[int], rho: Sequence[int],
             *, agg_op: str = "mean", name: str = "deepsets") -> ModelSpec:
    """Build a DeepSets ModelSpec (paper Table 3).

    input (M x F) -> phi MLP (per-element) -> global agg over M -> rho MLP.
    """
    layers: List[LayerSpec] = []
    k = in_features
    for i, n in enumerate(phi):
        layers.append(LayerSpec(kind="mm", M=M, K=k, N=n, bias=True, relu=True,
                                name=f"{name}.phi{i}"))
        k = n
    layers.append(LayerSpec(kind="agg", M=M, K=k, N=k, agg_op=agg_op,
                            name=f"{name}.agg"))
    for i, n in enumerate(rho):
        last = i == len(rho) - 1
        layers.append(LayerSpec(kind="mm", M=1, K=k, N=n, bias=True,
                                relu=not last, name=f"{name}.rho{i}"))
        k = n
    return ModelSpec(tuple(layers), name=name)


# ---------------------------------------------------------------------------
# Paper Table 3 workloads
# ---------------------------------------------------------------------------

def jsc_m() -> ModelSpec:
    return mlp(64, 16, [64, 32, 32, 32, 5], name="JSC-M")


def jsc_xl() -> ModelSpec:
    return mlp(64, 16, [128, 64, 64, 64, 5], name="JSC-XL")


def jsc_xl_d() -> ModelSpec:
    return mlp(64, 16, [128, 128, 64, 64, 64, 64, 64, 5], name="JSC-XL-d")


def deepsets_32() -> ModelSpec:
    return deepsets(32, 21, [32, 32, 32], [32, 10], name="Deepsets-32")


def deepsets_64() -> ModelSpec:
    return deepsets(64, 21, [64, 64, 64], [64, 10], name="Deepsets-64")


def deepsets_32_d() -> ModelSpec:
    return deepsets(32, 21, [32, 32, 32, 32, 32], [32, 10], name="Deepsets-32-d")


def deepsets_64_d() -> ModelSpec:
    return deepsets(64, 21, [64, 64, 64, 64, 64], [64, 10], name="Deepsets-64-d")


REALISTIC_WORKLOADS = {
    "JSC-M": jsc_m,
    "JSC-XL": jsc_xl,
    "JSC-XL-d": jsc_xl_d,
    "Deepsets-32": deepsets_32,
    "Deepsets-64": deepsets_64,
    "Deepsets-32-d": deepsets_32_d,
    "Deepsets-64-d": deepsets_64_d,
}
