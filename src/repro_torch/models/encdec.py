"""Whisper-style encoder-decoder backbone: the JAX package's
``src/repro/models/encdec.py``, for serving (conv/audio frontend stubbed).

As in the reference, the modality frontend is a stub: the caller hands in
precomputed frame embeddings (B, S_enc, d_model) where the conv1d stack
would produce them. The backbone: a bidirectional pre-norm encoder (GELU
MLP), a causal decoder with cross attention, learned positional embeddings
for the decoder, a tied unembedding.

Every attention of the prefill is one K5 bf16 call: the encoder's
non-causal (``attention`` with ``causal=False``), the decoder's causal
self-attention, and the cross attention, non-causal with S_dec queries
over T_enc keys (``flash_mha(causal=False)``). Decode attends over its
self cache and the encoder's cached K/V in plain PyTorch, as the
reference does outside any Pallas kernel.

The reference's ``shardctx.constrain_*`` calls in the cross attention
(:159-161) are the identity off a mesh and are left out. Its layers are
stacked on axis 0 and scanned; here ``EncDec.enc`` and ``EncDec.dec`` are
``ModuleList``s of one entry a layer, in order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attn import flash_mha
from . import attention as A
from . import blocks as B
from .transformer import WEIGHT_DTYPE, _Tree, load_tree, unstack

Params = Dict[str, Any]

#: Rows of the decoder's learned positions: the reference sizes them for
#: its 32k decode/prefill cells (whisper itself uses 448).
DEC_POSITIONS = 32768


def _acfg(cfg: ArchConfig, causal: bool) -> A.AttnConfig:
    # Whisper uses learned positional embeddings, not RoPE.
    return A.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv, head_dim=cfg.hd, causal=causal,
                        rope_theta=cfg.rope_theta, use_rope=False)


def init_params(cfg: ArchConfig, *, device, seed: int = 0) -> Params:
    """Random weights on ``device`` as the reference's ``_init`` scales them
    (``dec_pos`` at 0.01), from a ``torch.Generator`` seeded with ``seed``;
    matmul weights, biases, the embedding and ``dec_pos`` in WEIGHT_DTYPE,
    the layernorms f32. The numbers differ from the JAX package's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=WEIGHT_DTYPE, device=device)
    d = cfg.d_model

    def ln():
        return B.layernorm_init(d, device=device)

    def mlp():
        return B.gelu_mlp_init(gen, d, cfg.d_ff, **kw)

    enc = [{"ln1": ln(), "attn": A.attn_init(gen, _acfg(cfg, False), **kw),
            "ln2": ln(), "mlp": mlp()} for _ in range(cfg.enc_layers)]
    dec = [{"ln1": ln(), "self": A.attn_init(gen, _acfg(cfg, True), **kw),
            "ln2": ln(), "cross": A.attn_init(gen, _acfg(cfg, False), **kw),
            "ln3": ln(), "mlp": mlp()} for _ in range(cfg.n_layers)]
    return {"embedding": B.embedding_init(gen, cfg.vocab, d, **kw),
            "dec_pos": B._init(gen, (DEC_POSITIONS, d), scale=0.01, **kw),
            "enc": enc, "dec": dec,
            "enc_norm": ln(), "dec_norm": ln()}


class EncDec(nn.Module):
    """The encoder-decoder bound to an ArchConfig (``enc_layers > 0``) and
    its weights: ``{"embedding", "dec_pos", "enc": [a dict a layer], "dec":
    [...], "enc_norm", "dec_norm"}`` (``init_params``; ``params_from_numpy``
    for the reference's pytree). The tensors are used as given."""

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        if cfg.enc_layers <= 0:
            raise ValueError(f"{cfg.name}: enc_layers must be positive")
        if (len(params["enc"]), len(params["dec"])) != (cfg.enc_layers,
                                                        cfg.n_layers):
            raise ValueError(f"{len(params['enc'])} + {len(params['dec'])} "
                             f"layers of params for {cfg.enc_layers} + "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.embedding = _Tree(params["embedding"])
        self.register_parameter("dec_pos", nn.Parameter(
            params["dec_pos"], requires_grad=False))
        self.enc = nn.ModuleList(_Tree(p) for p in params["enc"])
        self.dec = nn.ModuleList(_Tree(p) for p in params["dec"])
        self.enc_norm = _Tree(params["enc_norm"])
        self.dec_norm = _Tree(params["dec_norm"])

    @property
    def device(self) -> torch.device:
        return self.embedding["emb"].device

    # -- encoder --------------------------------------------------------------
    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, d) stub embeddings -> encoder states."""
        acfg = _acfg(self.cfg, causal=False)
        x = frames
        for p in self.enc:
            x = x + A.attention(p["attn"], B.layernorm(p["ln1"], x), acfg)
            x = x + B.gelu_mlp(p["mlp"], B.layernorm(p["ln2"], x))
        return B.layernorm(self.enc_norm, x)

    # -- decoder full-sequence (prefill) ----------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) f32, aux loss 0)."""
        cfg = self.cfg
        enc = self.encode(frames)
        x = B.embed(self.embedding, tokens)
        S = x.shape[1]
        x = x + self.dec_pos[:S].to(x.dtype)[None]
        acfg = _acfg(cfg, causal=True)
        for p in self.dec:
            x = x + A.attention(p["self"], B.layernorm(p["ln1"], x), acfg)
            # cross attention: K/V from the encoder states
            x = x + _cross_attention(p["cross"], B.layernorm(p["ln2"], x),
                                     enc, cfg)
            x = x + B.gelu_mlp(p["mlp"], B.layernorm(p["ln3"], x))
        x = B.layernorm(self.dec_norm, x)
        return B.unembed(self.embedding, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    # -- decode -----------------------------------------------------------------
    @torch.no_grad()
    def init_cache(self, frames: torch.Tensor, max_len: int):
        """The cross attention's K/V from the encoder; empty self caches."""
        cfg = self.cfg
        enc = self.encode(frames)
        b = frames.shape[0]
        layers = []
        for p in self.dec:
            k, v = (B.dense(p["cross"][w], enc).reshape(b, -1, cfg.n_kv,
                                                        cfg.hd)
                    for w in ("wk", "wv"))
            layers.append({"xk": k, "xv": v, "self": A.init_cache(
                _acfg(cfg, True), b, max_len, device=frames.device)})
        return {"dec": layers, "pos": 0}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache) -> Tuple[torch.Tensor,
                                                              Any]:
        """token (B, 1) int; returns (logits (B,1,V) f32, cache). The self
        caches are updated in place (``attention.decode_step``)."""
        cfg = self.cfg
        x = B.embed(self.embedding, token)
        x = x + self.dec_pos[cache["pos"]].to(x.dtype)
        acfg = _acfg(cfg, causal=True)
        new: List[dict] = []
        for p, c in zip(self.dec, cache["dec"]):
            h, sc = A.decode_step(p["self"], B.layernorm(p["ln1"], x),
                                  c["self"], acfg)
            x = x + h
            x = x + _cross_attention_cached(
                p["cross"], B.layernorm(p["ln2"], x), c["xk"], c["xv"], cfg)
            x = x + B.gelu_mlp(p["mlp"], B.layernorm(p["ln3"], x))
            new.append({"xk": c["xk"], "xv": c["xv"], "self": sc})
        x = B.layernorm(self.dec_norm, x)
        return B.unembed(self.embedding, x), {"dec": new,
                                              "pos": cache["pos"] + 1}


def _cross_attention(p: Params, q_in: torch.Tensor, enc: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """The reference's unmasked ``_sdpa`` of S_dec queries over T_enc keys:
    one K5 bf16 call with ``causal=False``."""
    b, S, _ = q_in.shape
    hd = cfg.hd
    bf16 = torch.bfloat16
    q = B.dense(p["wq"], q_in).reshape(b, S, cfg.n_heads, hd)
    k = B.dense(p["wk"], enc).reshape(b, -1, cfg.n_kv, hd)
    v = B.dense(p["wv"], enc).reshape(b, -1, cfg.n_kv, hd)
    out = flash_mha(q.to(bf16), k.to(bf16), v.to(bf16), causal=False)
    return B.dense(p["wo"], out.to(q_in.dtype))


def _cross_attention_cached(p: Params, q_in: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    b, S, _ = q_in.shape
    q = B.dense(p["wq"], q_in).reshape(b, S, cfg.n_heads, cfg.hd)
    out = A._sdpa(q, k, v, None, cfg.n_heads // cfg.n_kv)
    return B.dense(p["wo"], out)


def params_from_numpy(cfg: ArchConfig, tree: Params, *,
                      device="cuda") -> EncDec:
    """An ``EncDec`` on ``device`` with the weights of the reference's param
    pytree, given as numpy arrays: ``enc`` and ``dec``, stacked on axis 0
    (the reference's vmapped init), are unstacked into one dict a
    layer. The layernorms become f32, every other leaf WEIGHT_DTYPE."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return EncDec(cfg, {
        "embedding": load_tree(tree["embedding"], dev),
        "dec_pos": load_tree(tree["dec_pos"], dev),
        "enc": [load_tree(unstack(tree["enc"], i), dev)
                for i in range(cfg.enc_layers)],
        "dec": [load_tree(unstack(tree["dec"], i), dev)
                for i in range(cfg.n_layers)],
        "enc_norm": load_tree(tree["enc_norm"], dev, path=("enc_norm",)),
        "dec_norm": load_tree(tree["dec_norm"], dev, path=("dec_norm",))})
