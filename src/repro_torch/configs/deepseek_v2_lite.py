"""DeepSeek-V2-Lite, on one chip's share of an expert-parallel deployment.

Source: https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json
(27 layers at d 2048; MLA with 16 heads, no query LoRA, ``kv_lora_rank``
512, query and key 128 wide without rope plus 64 with it, v 128; YaRN rope,
factor 40 over 4096 positions; layer 0 a dense SwiGLU of width 10,944;
layers 1-26 route each token to 6 of 64 experts of width 1,408 under
softmax gates that are not renormalised, beside 2 shared experts; untied
embeddings, vocabulary 102,400).

The model lies outside the JAX package's zoo, so its structure lives here,
in a subclass of ``ArchConfig`` (``DeepSeekV2Config``) that ``configs.get``
resolves beside the zoo's ``FULL``; the zoo's fields, ``FULL`` and
``ARCH_NAMES`` stay the JAX package's. Block kinds: ``mla`` (MLA and a
dense SwiGLU of ``d_ff``) for the leading dense layer, ``mla_moe`` (MLA and
the MoE layer) for the rest.

The cut to one chip: each MoE layer is split over 8 chips (8-way expert
parallelism) and this chip holds experts 0-7 of 64; the vocabulary is split
8 ways and this chip holds 12,800 of its 102,400 rows (the embedding's rows
and the head's columns). Depth is whole. ``n_experts`` stays the router's
width (64); ``experts_held`` names the chip's share, and ``vocab`` is the
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .base import ArchConfig, MLAParams
from .yarn import YaRN

ARCH = "deepseek-v2-lite"


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ArchConfig):
    """An ``ArchConfig`` with what DeepSeek-V2 adds: leading layers before
    the pattern's groups, an expert width apart from ``d_ff`` (the dense
    width), shared experts by number, the experts this chip holds, and YaRN
    on the rope. What every DeepSeek-V2 has is no field: the model layer
    gives it the published rope pairing, unrenormalised dropless routing
    and an untied head (``models.transformer``)."""
    pattern_head: Tuple[str, ...] = ()     #: layers before the first group
    expert_ff: int = 0                     #: routed expert width
    n_shared_experts: int = 0              #: one SwiGLU of n × expert_ff
    #: (first, count) of the routed experts this chip holds; None: all
    experts_held: Optional[Tuple[int, int]] = None
    yarn: Optional[YaRN] = None

    def __post_init__(self):
        body = self.n_layers - len(self.pattern_head) - len(self.pattern_tail)
        assert body > 0 and body % len(self.pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by pattern "
            f"{self.pattern}")

    @property
    def n_groups(self) -> int:
        return ((self.n_layers - len(self.pattern_head)
                 - len(self.pattern_tail)) // len(self.pattern))

    @property
    def n_held(self) -> int:
        return (self.experts_held[1] if self.experts_held is not None
                else self.n_experts)

    def _counts(self) -> Tuple[int, int, int, int]:
        """(MLA a layer, dense SwiGLU, one routed expert, a MoE layer's
        router and shared experts), in parameters."""
        d, m, H = self.d_model, self.mla, self.n_heads
        qk = m.qk_nope_dim + m.qk_rope_dim
        q = (d * H * qk if m.q_lora_rank is None else
             d * m.q_lora_rank + m.q_lora_rank * H * qk)
        mla = (q + d * (m.kv_lora_rank + m.qk_rope_dim)
               + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
               + H * m.v_head_dim * d)
        expert = 3 * d * self.expert_ff
        return (mla, 3 * d * self.d_ff, expert,
                d * self.n_experts + self.n_shared_experts * expert)

    def _n_moe(self) -> int:
        kinds = (list(self.pattern_head) + list(self.pattern) * self.n_groups
                 + list(self.pattern_tail))
        return sum(k == "mla_moe" for k in kinds)

    def param_count(self) -> int:
        """Parameters this configuration's model holds: every layer's MLA,
        the dense layers' SwiGLU, each MoE layer's router, shared experts
        and held experts, the embedding and the untied head, over the
        vocabulary held."""
        mla, dense, expert, moe_rest = self._counts()
        n_moe = self._n_moe()
        return (self.n_layers * mla + (self.n_layers - n_moe) * dense
                + n_moe * (moe_rest + self.n_held * expert)
                + 2 * self.vocab * self.d_model)

    def active_param_count(self) -> int:
        """Parameters a token touches, on average: of the held experts, the
        share ``top_k · held / n_experts`` that its routing reaches."""
        _, _, expert, _ = self._counts()
        touched = self.top_k * self.n_held * expert // self.n_experts
        return (self.param_count()
                - self._n_moe() * (self.n_held * expert - touched))


def config() -> DeepSeekV2Config:
    """DeepSeek-V2-Lite at its published widths, on one chip of 8: experts
    0-7 of each MoE layer's 64 and 12,800 of the 102,400 rows of the
    vocabulary (``experts_held=None, vocab=102_400`` would be the whole
    model)."""
    return DeepSeekV2Config(
        name=ARCH, family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=10_944,
        vocab=12_800,
        pattern=("mla_moe",), pattern_head=("mla",),
        mla=MLAParams(q_lora_rank=None, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        rope_theta=10_000.0,
        yarn=YaRN(factor=40.0, original_max_position=4096, beta_fast=32.0,
                  beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
        n_experts=64, top_k=6, shared_expert=True, expert_ff=1408,
        n_shared_experts=2, experts_held=(0, 8),
        sub_quadratic=False,
        note="8 chips share each layer: experts 0-7 of 64 and 12,800 of "
             "102,400 vocabulary rows held here")


def reduced() -> DeepSeekV2Config:
    """The same structure at CPU-test size: 1 dense and 2 MoE layers, d 64,
    4 heads, MLA 16 + 8 rope (both rope regimes of YaRN and its ramp at
    rope width 8), 16 experts of width 32 with 2 held, top-6, 2 shared,
    a vocabulary of 256."""
    return dataclasses.replace(
        config(), name=ARCH + "-reduced", n_layers=3, d_model=64, n_heads=4,
        n_kv=4, d_ff=128, vocab=256,
        mla=MLAParams(q_lora_rank=None, kv_lora_rank=16, qk_nope_dim=8,
                      qk_rope_dim=8, v_head_dim=8),
        n_experts=16, expert_ff=32, experts_held=(0, 2),
        note="CPU-test size")
