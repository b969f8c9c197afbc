"""Decoder-only model assembled from an ArchConfig: the dense family of the
JAX package's ``src/repro/models/transformer.py`` (qwen3, granite,
qwen1.5), for serving — the full-sequence prefill and one-token decode.

The reference scans over groups of layers with stacked parameters; here
``Transformer.layers`` is a ``ModuleList`` with one entry a block, in the
order the scan visits them (group by group, the pattern within a group,
then the tail). The matmul weights and the embedding are held in bf16 on
the device (the reference casts its f32 weights to bf16 at every use, so
the function is the same); norm scales stay f32.

Only the ``attn`` block kind is ported. The others raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from . import attention as A
from . import blocks as B

Params = Dict[str, Any]

#: Block kinds not ported yet -> what they need and the ROADMAP item.
NOT_PORTED = {
    "attn_moe": "mixture of experts (llama4, mixtral): ROADMAP.md §1 M9b",
    "mla": "multi-head latent attention (minicpm3): ROADMAP.md §1 M9b",
    "rglru": "RG-LRU recurrence (recurrentgemma): ROADMAP.md §1 M9c",
    "mlstm": "xLSTM matrix memory (xlstm): ROADMAP.md §1 M9c",
    "slstm": "xLSTM scalar memory (xlstm): ROADMAP.md §1 M9c",
}
#: Param dicts that hold norm scales/biases (kept f32); every other leaf is a
#: matmul weight, bias or the embedding, held in WEIGHT_DTYPE.
NORM_KEYS = ("ln1", "ln2", "qnorm", "knorm", "final_norm")
WEIGHT_DTYPE = torch.bfloat16


def check_kind(kind: str) -> None:
    """Raises for a block kind this module does not run."""
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: {NOT_PORTED[kind]}")
    if kind != "attn":
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# per-kind config extraction
# ---------------------------------------------------------------------------

def _attn_cfg(cfg: ArchConfig) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        window=cfg.window, rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections,
        cache_dtype=cfg.kv_cache_dtype)


def _norm_init(cfg: ArchConfig, device=None):
    return (B.rmsnorm_init if cfg.norm_kind == "rms"
            else B.layernorm_init)(cfg.d_model, device=device)


def _norm(cfg: ArchConfig, p, x):
    return (B.rmsnorm if cfg.norm_kind == "rms" else B.layernorm)(p, x)


def _mlp_init(gen, cfg: ArchConfig, device):
    return (B.swiglu_init if cfg.mlp_kind == "swiglu"
            else B.gelu_mlp_init)(gen, cfg.d_model, cfg.d_ff,
                                  dtype=WEIGHT_DTYPE, device=device)


def _mlp(cfg: ArchConfig, p, x):
    return (B.swiglu if cfg.mlp_kind == "swiglu" else B.gelu_mlp)(p, x)


# ---------------------------------------------------------------------------
# block init / apply / cache / decode — dispatch on kind
# ---------------------------------------------------------------------------

def block_init(gen, kind: str, cfg: ArchConfig, device=None) -> Params:
    check_kind(kind)
    return {"ln1": _norm_init(cfg, device),
            "attn": A.attn_init(gen, _attn_cfg(cfg), dtype=WEIGHT_DTYPE,
                                device=device),
            "ln2": _norm_init(cfg, device),
            "mlp": _mlp_init(gen, cfg, device)}


def block_apply(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence residual block. Returns (x, aux_loss)."""
    check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + A.attention(p["attn"], _norm(cfg, p["ln1"], x), _attn_cfg(cfg),
                        positions)
    x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
    return x, aux


def block_cache_init(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                     device=None):
    check_kind(kind)
    acfg = _attn_cfg(cfg)
    # sliding-window caches are ring buffers of size window
    n = min(max_len, acfg.window) if acfg.window else max_len
    return A.init_cache(acfg, batch, n, device=device)


def block_decode(kind: str, p: Params, x: torch.Tensor, cache,
                 cfg: ArchConfig):
    check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h, cache = A.decode_step(p["attn"], _norm(cfg, p["ln1"], x), cache,
                             _attn_cfg(cfg))
    x = x + h
    x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x))
    return x, cache, aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _frozen(tree: Params) -> nn.Module:
    """A nested dict of tensors as nested ModuleDict/ParameterDict, the
    tensors shared (not copied) and frozen: the port serves, it does not
    train yet."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _frozen(v) for k, v in tree.items()})


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """The block kinds in the order the reference's scan visits them."""
    return list(cfg.pattern) * cfg.n_groups + list(cfg.pattern_tail)


def init_params(cfg: ArchConfig, *, device, seed: int = 0) -> Params:
    """Random weights on ``device`` as the reference's ``_init`` scales them
    (1/sqrt(d_in); 1.0 for the embedding), from a ``torch.Generator`` seeded
    with ``seed``; drawn f32 one tensor at a time and cast to WEIGHT_DTYPE.
    The numbers differ from the JAX package's for the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"embedding": B.embedding_init(gen, cfg.vocab, cfg.d_model,
                                          dtype=WEIGHT_DTYPE, device=device),
            "final_norm": _norm_init(cfg, device),
            "layers": [block_init(gen, kind, cfg, device=device)
                       for kind in layer_kinds(cfg)]}


class Transformer(nn.Module):
    """The model bound to an ArchConfig and its weights.

    ``params`` is ``{"embedding", "final_norm", "layers": [one dict a
    block]}`` (``init_params``; ``params_from_numpy`` for the reference's
    pytree). The tensors are used as given, not copied.
    """

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        if len(params["layers"]) != len(self.kinds):
            raise ValueError(f"{len(params['layers'])} layers of params for "
                             f"{len(self.kinds)} blocks")
        for k in self.kinds:
            check_kind(k)
        self.embedding = _frozen(params["embedding"])
        self.final_norm = _frozen(params["final_norm"])
        self.layers = nn.ModuleList(_frozen(p) for p in params["layers"])

    @property
    def device(self) -> torch.device:
        return self.embedding["emb"].device

    # -- full-sequence forward (prefill) --------------------------------------
    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor],
                embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) f32, aux loss scalar). ``embeds``
        overrides the token embedding (stub frontends)."""
        cfg = self.cfg
        x = embeds if embeds is not None else B.embed(self.embedding, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p in zip(self.kinds, self.layers):
            x, a = block_apply(kind, p, x, cfg, positions)
            aux = aux + a
        x = _norm(cfg, self.final_norm, x)
        return B.unembed(self.embedding, x), aux

    # -- KV cache ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        return {"layers": [block_cache_init(kind, self.cfg, batch, max_len,
                                            device=self.device)
                           for kind in self.kinds],
                "pos": 0}

    # -- one-token decode --------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, token: Optional[torch.Tensor], cache,
                    embeds: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Any]:
        """token: (B, 1) int (or embeds (B, 1, d)); returns (logits, cache).
        The caches are updated in place (``attention.decode_step``)."""
        cfg = self.cfg
        x = embeds if embeds is not None else B.embed(self.embedding, token)
        new = []
        for kind, p, c in zip(self.kinds, self.layers, cache["layers"]):
            x, c, _ = block_decode(kind, p, x, c, cfg)
            new.append(c)
        x = _norm(cfg, self.final_norm, x)
        return B.unembed(self.embedding, x), {"layers": new,
                                              "pos": cache["pos"] + 1}


def params_from_numpy(cfg: ArchConfig, tree: Params, *,
                      device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` with the weights of the reference's
    param pytree, given as numpy arrays: ``groups`` is unstacked along axis
    0 into the layers, then ``tail``. Norm leaves become f32, every other
    leaf WEIGHT_DTYPE."""
    from repro_torch import resolve_device
    dev = resolve_device(device)

    def load(sub, norm=False):
        if isinstance(sub, dict):
            return {k: load(v, norm or k in NORM_KEYS) for k, v in sub.items()}
        return torch.from_numpy(np.array(sub, dtype=np.float32)).to(
            dev, torch.float32 if norm else WEIGHT_DTYPE)

    def take(sub, g):
        if isinstance(sub, dict):
            return {k: take(v, g) for k, v in sub.items()}
        return sub[g]

    layers = [load(take(tree["groups"], g)[f"b{i}"])
              for g in range(cfg.n_groups) for i in range(len(cfg.pattern))]
    layers += [load(p) for p in tree.get("tail", [])]
    return Transformer(cfg, {
        "embedding": load(tree["embedding"]),
        "final_norm": load(tree["final_norm"], norm=True),
        "layers": layers})
