"""Hand-written CUDA kernels for Hopper (``sm_90a``).

* ``mm_int8``      — one INT8 layer with the fused bias/ReLU/requant epilogue
                     (the per-layer baseline) on the tensor cores
                     (``mma.sync`` s8); replaces ``mm_int8_pallas``
* ``cascade_mlp``  — the whole INT8 layer chain in one launch with weights
                     resident in shared memory (``cascade_mlp``, K2), the
                     fused DeepSets (``deepsets``, K3: phi, the set sum and
                     rho, one warp an event), both on the tensor cores
                     (``mma.sync`` s8), and the per-layer chain of K1
                     launches (``mlp_unfused``)
* ``global_agg``   — the INT8 set reduction (K4), one launch on the caller's
                     matrix, as a dp4a against a ones word (``impl="mac"``)
                     or serial row adds (``impl="extract_add"``); replaces
                     ``global_agg_pallas``
* ``flash_attn``   — online-softmax attention (``flash_attention``, K5): f32
                     on the FMA units, bf16 on the tensor cores (``wgmma``,
                     f32 accumulation); and its causal GQA wrapper
                     (``flash_mha``); replaces ``flash_attention``

Each kernel has ``ops.py`` (the wrapper: checks, dispatch, launch count) and
``ref.py`` (its plain PyTorch version). The CUDA sources are in ``csrc/``
and are built by ``_build`` at first use. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises.
"""
from . import cascade_mlp, flash_attn, global_agg, mm_int8
from ._build import launches

__all__ = ["mm_int8", "cascade_mlp", "global_agg", "flash_attn", "launches"]
