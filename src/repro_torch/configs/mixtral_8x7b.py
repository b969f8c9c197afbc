"""Config module for ``--arch mixtral-8x7b``.

Thin accessor over the registry in :mod:`repro_torch.configs.archs` (single
source of truth; see its docstring for provenance and structure notes).
"""
from repro_torch.configs.archs import mixtral_8x7b as full
from repro_torch.configs.archs import get_reduced as _gr

ARCH = "mixtral-8x7b"


def config():
    """The FULL assigned configuration (dry-run scale)."""
    return full()


def reduced():
    """Small same-family config for CPU smoke tests."""
    return _gr(ARCH)
