"""Config module for ``--arch qwen2-vl-72b``.

Thin accessor over the registry in :mod:`repro_torch.configs.archs` (single
source of truth; see its docstring for provenance and structure notes).
"""
from repro_torch.configs.archs import qwen2_vl_72b as full
from repro_torch.configs.archs import get_reduced as _gr

ARCH = "qwen2-vl-72b"


def config():
    """The FULL assigned configuration (dry-run scale)."""
    return full()


def reduced():
    """Small same-family config for CPU smoke tests."""
    return _gr(ARCH)
