"""YaRN's rope scaling (the published ``rope_scaling`` of type yarn), as a
config states it; ``models.attention`` computes its frequencies and softmax
scale from it."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class YaRN:
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(factor: float, mscale: float) -> float:
    """The published ``yarn_get_mscale``: 0.1·mscale·ln(factor) + 1 above a
    factor of 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0
