"""The paper's own jet-tagging workloads (Table 3) as config accessors.

These are Tier-A ``ModelSpec`` chains (``repro_torch.core.layerspec``), not
ArchConfigs — the paper's model class runs through the DSE + the fused
cascade kernels rather than the LM substrate.
"""
from repro_torch.core.layerspec import (REALISTIC_WORKLOADS, deepsets, jsc_m,
                                  jsc_xl, jsc_xl_d, deepsets_32, deepsets_64,
                                  deepsets_32_d, deepsets_64_d, mlp,
                                  synthetic_mlp)

__all__ = ["REALISTIC_WORKLOADS", "deepsets", "jsc_m", "jsc_xl", "jsc_xl_d",
           "deepsets_32", "deepsets_64", "deepsets_32_d", "deepsets_64_d",
           "mlp", "synthetic_mlp"]
