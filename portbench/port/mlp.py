"""An MLP through the port: ``kernels.cascade_mlp.cascade_mlp`` (K2 on a
CUDA tensor), one launch a batch."""
from __future__ import annotations

from . import quantized_mlp


def build(cfg, model):
    from repro_torch.kernels.cascade_mlp import cascade_mlp, prepare
    q = quantized_mlp(model["e_in"], model["stages"]["mlp"])
    prepare(q)

    def forward(x):
        return cascade_mlp(x, q)
    return forward
