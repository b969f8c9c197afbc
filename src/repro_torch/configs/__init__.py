"""Config registry: ``--arch <id>`` lookup for the 10 assigned architectures
plus the paper's own jet-tagging workloads (Tier A, in repro_torch.core.layerspec).
"""
from .base import ArchConfig, MLAParams, ShapeSpec, SHAPES, SHAPES_BY_NAME, \
    cell_runnable
from .archs import ARCH_NAMES, FULL, get, get_reduced

__all__ = ["ArchConfig", "MLAParams", "ShapeSpec", "SHAPES", "SHAPES_BY_NAME",
           "cell_runnable", "ARCH_NAMES", "FULL", "get", "get_reduced"]
