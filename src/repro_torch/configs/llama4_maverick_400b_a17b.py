"""Config module for ``--arch llama4-maverick-400b-a17b``.

Thin accessor over the registry in :mod:`repro_torch.configs.archs` (single
source of truth; see its docstring for provenance and structure notes).
"""
from repro_torch.configs.archs import llama4_maverick_400b_a17b as full
from repro_torch.configs.archs import get_reduced as _gr

ARCH = "llama4-maverick-400b-a17b"


def config():
    """The FULL assigned configuration (dry-run scale)."""
    return full()


def reduced():
    """Small same-family config for CPU smoke tests."""
    return _gr(ARCH)
