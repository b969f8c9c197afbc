from .ops import MAX_HEAD_DIM, flash_attention, flash_mha
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_mha", "flash_attention_ref",
           "MAX_HEAD_DIM"]
