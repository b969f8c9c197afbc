"""Config module for ``--arch recurrentgemma-2b``.

Thin accessor over the registry in :mod:`repro_torch.configs.archs` (single
source of truth; see its docstring for provenance and structure notes).
"""
from repro_torch.configs.archs import recurrentgemma_2b as full
from repro_torch.configs.archs import get_reduced as _gr

ARCH = "recurrentgemma-2b"


def config():
    """The FULL assigned configuration (dry-run scale)."""
    return full()


def reduced():
    """Small same-family config for CPU smoke tests."""
    return _gr(ARCH)
