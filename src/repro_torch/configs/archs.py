"""The 10 architectures of the model zoo, at their published widths.

Each ``<id>()`` returns the FULL config and ``get_reduced(<name>)`` a small
same-family config for CPU smoke tests (``models.build`` builds every
arch, full or reduced, on the card or the CPU). Sources are noted per entry;
μ-ORCA-technique applicability is in DESIGN.md §4 (the technique's T2/T3
components apply to every arch; T1 whole-model fusion applies fully only to
the jet-tagging model class).
"""
from __future__ import annotations

import dataclasses

from . import deepseek_v2_lite
from .base import ArchConfig, MLAParams


def llama4_maverick_400b_a17b() -> ArchConfig:
    """[moe] 48L d=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.

    Alternating dense/MoE layers (interleave step 2) with a shared expert on
    MoE layers — Llama-4 structure [hf:meta-llama/Llama-4-*; unverified].
    Full attention -> long_500k skipped.
    """
    return ArchConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
        vocab=202_048, head_dim=128,
        pattern=("attn", "attn_moe"),
        n_experts=128, top_k=1, shared_expert=True,
        rope_theta=500_000.0,
        sub_quadratic=False,
        note="early-fusion multimodal in the original; text backbone here")


def mixtral_8x7b() -> ArchConfig:
    """[moe] 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8e top-2, SWA.

    [arXiv:2401.04088]. Sliding window 4096 bounds the decode cache ->
    long_500k runnable (O(window) per layer).
    """
    return ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
        vocab=32_000, head_dim=128,
        pattern=("attn_moe",),
        n_experts=8, top_k=2, window=4096,
        rope_theta=1_000_000.0,
        sub_quadratic=True,
        note="SWA ring-buffer cache makes 524k-context decode O(window)")


def xlstm_350m() -> ArchConfig:
    """[ssm] 24L d=1024 4H vocab=50304, sLSTM + mLSTM blocks (7:1 ratio),
    d_ff=0 (block-internal projections) [arXiv:2405.04517; unverified]."""
    return ArchConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_ff=0,
        vocab=50_304,
        pattern=("mlstm",) * 7 + ("slstm",),
        slstm_heads=4,
        # chunk 512 (vs 128): 4x fewer chunk-boundary (B,H,hd,hd) carries
        # saved for the backward scan — the dominant train_4k buffer
        # (chunkwise mLSTM is exact for any chunk; EXPERIMENTS.md §Perf)
        mlstm_chunk=512,
        sub_quadratic=True,
        note="matrix/scalar LSTM memories; O(1)-state decode")


def qwen3_14b() -> ArchConfig:
    """[dense] 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, qk_norm
    [hf:Qwen/Qwen3-14B]."""
    return ArchConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv=8, d_ff=17408,
        vocab=151_936, head_dim=128,
        pattern=("attn",), qk_norm=True,
        rope_theta=1_000_000.0,
        sub_quadratic=False)


def granite_8b() -> ArchConfig:
    """[dense] 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152, llama-arch
    code model [arXiv:2405.04324]."""
    return ArchConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
        vocab=49_152, head_dim=128,
        pattern=("attn",),
        rope_theta=10_000_000.0,
        sub_quadratic=False)


def qwen15_32b() -> ArchConfig:
    """[dense] 64L d=5120 40H (MHA kv=40) d_ff=27392 vocab=152064, QKV bias
    [hf:Qwen/Qwen1.5-32B]."""
    return ArchConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392,
        vocab=152_064, head_dim=128,
        pattern=("attn",), qkv_bias=True,
        rope_theta=1_000_000.0,
        sub_quadratic=False)


def minicpm3_4b() -> ArchConfig:
    """[dense] 62L d=2560 40H d_ff=6400 vocab=73448, MLA
    [hf:openbmb/MiniCPM3-4B]."""
    return ArchConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv=40, d_ff=6400,
        vocab=73_448,
        pattern=("mla",),
        mla=MLAParams(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
        sub_quadratic=False,
        note="latent KV cache (rank 256 + rope 32) instead of per-head K/V")


def recurrentgemma_2b() -> ArchConfig:
    """[hybrid] 26L d=2560 10H (MQA kv=1) d_ff=7680 vocab=256000,
    RG-LRU + local attention 1:2 [arXiv:2402.19427]."""
    return ArchConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680,
        vocab=256_000, head_dim=256,
        pattern=("rglru", "rglru", "attn"),
        pattern_tail=("rglru", "rglru"),
        window=2048, mlp_kind="gelu",
        sub_quadratic=True,
        note="8x(rglru,rglru,local-attn)+2 rglru tail = 26L, 18:8 ratio")


def whisper_base() -> ArchConfig:
    """[audio] 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865, enc-dec with
    conv frontend STUB (precomputed frame embeddings) [arXiv:2212.04356]."""
    return ArchConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
        vocab=51_865,
        pattern=("attn",), enc_layers=6,
        mlp_kind="gelu", norm_kind="ln",
        frontend="audio_stub",
        sub_quadratic=False)


def qwen2_vl_72b() -> ArchConfig:
    """[vlm] 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, M-RoPE,
    vision frontend STUB (precomputed patch embeddings) [arXiv:2409.12191]."""
    return ArchConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568,
        vocab=152_064, head_dim=128,
        pattern=("attn",), qkv_bias=True,
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        sub_quadratic=False)


# ---------------------------------------------------------------------------
# Reduced configs — same family/block structure, smoke-test sized
# ---------------------------------------------------------------------------

def _reduce(cfg: ArchConfig, **over) -> ArchConfig:
    base = dict(
        name=cfg.name + "-reduced", n_layers=len(cfg.pattern) * 2
        + len(cfg.pattern_tail),
        d_model=64, n_heads=4, n_kv=min(cfg.n_kv, 2) if cfg.n_kv
        < cfg.n_heads else 4, d_ff=128 if cfg.d_ff else 0, vocab=256,
        head_dim=16, window=min(cfg.window, 8) if cfg.window else None,
        n_experts=4 if cfg.n_experts else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        mla=MLAParams(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                      qk_rope_dim=4, v_head_dim=8) if cfg.mla else None,
        mlstm_chunk=8, slstm_heads=2,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
    )
    base.update(over)
    return dataclasses.replace(cfg, **base)


REDUCED_OVERRIDES = {}

FULL = {
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "mixtral-8x7b": mixtral_8x7b,
    "xlstm-350m": xlstm_350m,
    "qwen3-14b": qwen3_14b,
    "granite-8b": granite_8b,
    "qwen1.5-32b": qwen15_32b,
    "minicpm3-4b": minicpm3_4b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "whisper-base": whisper_base,
    "qwen2-vl-72b": qwen2_vl_72b,
}


#: Architectures outside the JAX package's zoo (so outside ``FULL`` and
#: ``ARCH_NAMES``, which mirror it): name -> (full, reduced).
MORE = {deepseek_v2_lite.ARCH: (deepseek_v2_lite.config,
                                deepseek_v2_lite.reduced)}


def get(name: str) -> ArchConfig:
    return MORE[name][0]() if name in MORE else FULL[name]()


def get_reduced(name: str) -> ArchConfig:
    return MORE[name][1]() if name in MORE else _reduce(FULL[name]())


ARCH_NAMES = tuple(FULL.keys())
