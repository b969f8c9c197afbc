"""PyTorch/CUDA port of the repro package for an NVIDIA H100.

The INT8 jet-tagging deployment runs here end to end: power-of-two PTQ
(``quant``), hand-written CUDA kernels for Hopper (``kernels``), the
micro-batching ``serve.JetServer`` and the ``launch.serve`` driver. The JAX
package ``repro`` stays the reference the port is held against; this package
imports nothing of it.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
and raises when CUDA is absent. The plain PyTorch versions of the kernels
run only when the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
