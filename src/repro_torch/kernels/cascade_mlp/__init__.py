from .ops import (cascade_mlp, deepsets, mlp_unfused, packed_mma_chain,
                  prepare)
from .ref import cascade_mlp_ref, deepsets_ref, global_agg_ref

__all__ = ["cascade_mlp", "deepsets", "mlp_unfused", "packed_mma_chain",
           "prepare",
           "cascade_mlp_ref", "deepsets_ref", "global_agg_ref"]
