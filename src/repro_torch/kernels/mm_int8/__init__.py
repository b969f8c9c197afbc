from .ops import mm_int8
from .ref import mm_int8_ref

__all__ = ["mm_int8", "mm_int8_ref"]
