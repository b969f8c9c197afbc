"""Architecture configuration schema + input shape definitions.

One ``ArchConfig`` fully determines a model in :mod:`repro_torch.models.transformer`
(or :mod:`repro_torch.models.encdec` when ``enc_layers > 0``). Layer structure
is a repeating ``pattern`` of block kinds plus an optional ``pattern_tail`` —
the pattern group is the reference's unit of scan over depth; the port runs
the groups as consecutive entries of ``Transformer.layers``.

Block kinds:
  attn        self-attention (GQA/MHA per n_kv) + MLP
  attn_moe    self-attention + mixture-of-experts FFN
  mla         multi-head latent attention + MLP (minicpm3)
  rglru       RG-LRU temporal block + MLP (recurrentgemma)
  mlstm       xLSTM matrix-memory block (internal up/down proj)
  slstm       xLSTM scalar-memory block (internal FFN)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAParams:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    #: dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    pattern: Tuple[str, ...] = ("attn",)
    pattern_tail: Tuple[str, ...] = ()
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None          #: SWA/local attention window
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # MoE
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False
    # MLA
    mla: Optional[MLAParams] = None
    # block internals
    mlp_kind: str = "swiglu"              #: swiglu|gelu
    norm_kind: str = "rms"                #: rms|ln
    mlstm_chunk: int = 128
    slstm_heads: int = 4
    # encoder-decoder (whisper)
    enc_layers: int = 0
    frontend: str = "none"                #: none|audio_stub|vision_stub
    # serving
    kv_cache_dtype: str = "bfloat16"      #: "int8" halves KV-cache HBM
    # capabilities / notes
    sub_quadratic: bool = False           #: can run long_500k decode
    note: str = ""

    def __post_init__(self):
        body = self.n_layers - len(self.pattern_tail)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by pattern "
            f"{self.pattern}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.pattern_tail)) // len(self.pattern)

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        att = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        if self.mla is not None:
            m = self.mla
            att = (d * m.q_lora_rank
                   + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                   + d * (m.kv_lora_rank + m.qk_rope_dim)
                   + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                   + self.n_heads * m.v_head_dim * d)
        mlp = 3 * d * self.d_ff if self.mlp_kind == "swiglu" else 2 * d * self.d_ff
        moe = d * self.n_experts + 3 * self.n_experts * d * self.d_ff
        if self.shared_expert:
            moe += 3 * d * self.d_ff
        rglru = 4 * d * d + 2 * d * d      # in/out/gates projections
        mlstm = (2 + 3 * 4 + 1) * d * d    # up,gate (2d), qkv over 2d, down
        slstm = 6 * d * d + 2 * d * int(4 / 3 * d) + d * d

        per_kind = {"attn": att + mlp, "attn_moe": att + moe,
                    "mla": att + mlp, "rglru": rglru + mlp,
                    "mlstm": mlstm, "slstm": slstm}
        body = sum(per_kind[k] for k in self.pattern) * self.n_groups
        tail = sum(per_kind[k] for k in self.pattern_tail)
        enc = self.enc_layers * (att + mlp) if self.enc_layers else 0
        cross = self.n_layers * att if self.enc_layers else 0
        return body + tail + enc + cross + self.vocab * d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        full_moe_ffn = 3 * self.n_experts * d * self.d_ff
        active_ffn = 3 * self.top_k * d * self.d_ff
        n_moe_layers = (sum(1 for k in self.pattern if k == "attn_moe")
                        * self.n_groups)
        return (self.param_count()
                - n_moe_layers * (full_moe_ffn - active_ffn))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            #: train|prefill|decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is this (arch x shape) cell runnable? Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: pure full-attention arch — 524k-token decode "
                       "needs sub-quadratic attention (DESIGN.md §4)")
    return True, ""
