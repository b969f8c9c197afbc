from .ops import DEFAULT_BLOCK_F, global_agg
from .ref import global_agg_ref

__all__ = ["global_agg", "global_agg_ref", "DEFAULT_BLOCK_F"]
