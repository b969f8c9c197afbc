"""Float jet-tagging models (MLP, DeepSets) in the JAX package's layout."""
from . import deepsets, mlp
from .deepsets import DeepSets
from .mlp import MLP

__all__ = ["deepsets", "mlp", "DeepSets", "MLP"]
