"""DeepSets through the port: ``kernels.cascade_mlp.deepsets`` (K3 on a
CUDA tensor), one launch a batch."""
from __future__ import annotations

from . import quantized_mlp


def build(cfg, model):
    from repro_torch.kernels.cascade_mlp import deepsets, prepare
    phi_layers = model["stages"]["phi"]
    phi = quantized_mlp(model["e_in"], phi_layers)
    rho = quantized_mlp(phi_layers[-1].e_out, model["stages"]["rho"])
    prepare(phi, rho)

    def forward(x):
        return deepsets(x, phi, rho, agg="mean")
    return forward
