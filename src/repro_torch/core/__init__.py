"""μ-ORCA core: the paper's contribution, and the H100's latency model.

Tier A (paper-faithful): AIE-ML analytical performance model (Eqs. 1-6),
mapping/placement, and the §5.2 design space exploration, all models of
the AMD VEK280 in numpy, equal number for number to the JAX package's.

Tier B (H100): the overhead-aware latency model of one chain on the card
and the shared-memory fusion planner (see :mod:`repro_torch.core.h100_model`
and :mod:`repro_torch.core.fusion_planner`), backing the fused cascade
kernels.
"""
from . import aie_arch, layerspec, mapping, placement, perfmodel, dse, baselines
from . import h100_model, fusion_planner

__all__ = [
    "aie_arch", "layerspec", "mapping", "placement", "perfmodel", "dse",
    "baselines", "h100_model", "fusion_planner",
]
