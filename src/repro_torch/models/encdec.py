"""Whisper-style encoder-decoder backbone: the JAX package's
``src/repro/models/encdec.py`` (conv/audio frontend stubbed).

As in the reference, the modality frontend is a stub: the caller hands in
precomputed frame embeddings (B, S_enc, d_model) where the conv1d stack
would produce them. The backbone: a bidirectional pre-norm encoder (GELU
MLP), a causal decoder with cross attention, learned positional embeddings
for the decoder, a tied unembedding.

Without a gradient to carry, every attention of the forward is one K5
bf16 call: the encoder's non-causal (``attention`` with ``causal=False``),
the decoder's causal self-attention, and the cross attention, non-causal
with S_dec queries over T_enc keys (``flash_mha(causal=False)``). Training
runs the reference's own ``_sdpa`` (and the causal branches of
``attention``) under autograd instead, and ``remat`` checkpoints each
encoder and decoder layer, as the reference's ``checkpoint`` of its scanned
layer does. Decode attends over its self cache and the encoder's cached
K/V in plain PyTorch, as the reference does outside any Pallas kernel.

The reference's ``shardctx.constrain_*`` calls in the cross attention
(:159-161) are the identity off a mesh and are left out. Its layers are
stacked on axis 0 and scanned; here ``EncDec.enc`` and ``EncDec.dec`` are
``ModuleList``s of one entry a layer, in order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attn import flash_mha
from . import attention as A
from . import blocks as B
from .transformer import (WEIGHT_DTYPE, _Tree, load_tree, stack, to_cpu,
                          unstack)

Params = Dict[str, Any]

#: Rows of the decoder's learned positions: the reference sizes them for
#: its 32k decode/prefill cells (whisper itself uses 448).
DEC_POSITIONS = 32768


def _acfg(cfg: ArchConfig, causal: bool) -> A.AttnConfig:
    # Whisper uses learned positional embeddings, not RoPE.
    return A.AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv, head_dim=cfg.hd, causal=causal,
                        rope_theta=cfg.rope_theta, use_rope=False)


def init_params(cfg: ArchConfig, *, device, seed: int = 0,
                weight_dtype=WEIGHT_DTYPE) -> Params:
    """Random weights on ``device`` as the reference's ``_init`` scales them
    (``dec_pos`` at 0.01), from a ``torch.Generator`` seeded with ``seed``;
    matmul weights, biases, the embedding and ``dec_pos`` in
    ``weight_dtype``, the layernorms f32. The numbers differ from the JAX
    package's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=weight_dtype, device=device)
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
    for the reference's pytree). The tensors are used as given. ``remat``
    checkpoints each layer of a forward that carries a gradient."""

    def __init__(self, cfg: ArchConfig, params: Params, *,
                 remat: bool = False):
        super().__init__()
        if cfg.enc_layers <= 0:
            raise ValueError(f"{cfg.name}: enc_layers must be positive")
        if (len(params["enc"]), len(params["dec"])) != (cfg.enc_layers,
                                                        cfg.n_layers):
            raise ValueError(f"{len(params['enc'])} + {len(params['dec'])} "
                             f"layers of params for {cfg.enc_layers} + "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.remat = remat
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

    def params(self) -> Params:
        """The weights in this layout, the tensors themselves."""
        return {"embedding": self.embedding.tree(), "dec_pos": self.dec_pos,
                "enc": [p.tree() for p in self.enc],
                "dec": [p.tree() for p in self.dec],
                "enc_norm": self.enc_norm.tree(),
                "dec_norm": self.dec_norm.tree()}

    def cast(self, weight_dtype) -> "EncDec":
        """A copy of the model with its weights in ``weight_dtype`` (the
        layernorms stay f32), frozen."""
        return EncDec(self.cfg, _port_tree(self.params(), self.device,
                                           weight_dtype), remat=self.remat)

    def _layers(self, fn, x, layers, *args):
        """``fn(p, x, *args)`` over ``layers``, each checkpointed when the
        model's ``remat`` and grad mode are on."""
        remat = self.remat and torch.is_grad_enabled()
        for p in layers:
            x = (checkpoint(fn, p, x, *args, use_reentrant=False,
                            preserve_rng_state=False) if remat
                 else fn(p, x, *args))
        return x

    # -- encoder --------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, d) stub embeddings -> encoder states."""
        x = self._layers(_enc_layer, frames, self.enc, self.cfg)
        return B.layernorm(self.enc_norm, x)

    # -- decoder full-sequence (train / prefill) --------------------------------
    def forward(self, tokens: torch.Tensor, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) f32, aux loss 0)."""
        cfg = self.cfg
        enc = self.encode(frames)
        x = B.embed(self.embedding, tokens)
        S = x.shape[1]
        x = x + self.dec_pos[:S].to(x.dtype)[None]
        x = self._layers(_dec_layer, x, self.dec, enc, cfg)
        x = B.layernorm(self.dec_norm, x)
        return B.unembed(self.embedding, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    # -- decode -----------------------------------------------------------------
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

    def decode_step(self, token: torch.Tensor, cache) -> Tuple[torch.Tensor,
                                                              Any]:
        """token (B, 1) int; returns (logits (B,1,V) f32, cache). The self
        caches are updated in place (``attention.decode_step``). The
        position row is ``min(pos, DEC_POSITIONS - 1)``, as the reference's
        ``dynamic_slice_in_dim`` clamps a start past the table."""
        cfg = self.cfg
        x = B.embed(self.embedding, token)
        row = min(cache["pos"], self.dec_pos.shape[0] - 1)
        x = x + self.dec_pos[row].to(x.dtype)
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


def _enc_layer(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = x + A.attention(p["attn"], B.layernorm(p["ln1"], x),
                        _acfg(cfg, causal=False))
    return x + B.gelu_mlp(p["mlp"], B.layernorm(p["ln2"], x))


def _dec_layer(p: Params, x: torch.Tensor, enc: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    x = x + A.attention(p["self"], B.layernorm(p["ln1"], x),
                        _acfg(cfg, causal=True))
    # cross attention: K/V from the encoder states
    x = x + _cross_attention(p["cross"], B.layernorm(p["ln2"], x), enc, cfg)
    return x + B.gelu_mlp(p["mlp"], B.layernorm(p["ln3"], x))


def _cross_attention(p: Params, q_in: torch.Tensor, enc: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """The reference's unmasked ``_sdpa`` of S_dec queries over T_enc keys:
    one K5 bf16 call with ``causal=False``, or the reference's ``_sdpa``
    itself where a gradient is carried (``attention.needs_grad``)."""
    b, S, _ = q_in.shape
    hd = cfg.hd
    bf16 = torch.bfloat16
    q = B.dense(p["wq"], q_in).reshape(b, S, cfg.n_heads, hd)
    k = B.dense(p["wk"], enc).reshape(b, -1, cfg.n_kv, hd)
    v = B.dense(p["wv"], enc).reshape(b, -1, cfg.n_kv, hd)
    if A.needs_grad(q, k, v):
        out = A._sdpa(q, k, v, None, cfg.n_heads // cfg.n_kv)
    else:
        out = flash_mha(q.to(bf16), k.to(bf16), v.to(bf16),
                        causal=False).to(q_in.dtype)
    return B.dense(p["wo"], out)


def _cross_attention_cached(p: Params, q_in: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    b, S, _ = q_in.shape
    q = B.dense(p["wq"], q_in).reshape(b, S, cfg.n_heads, cfg.hd)
    out = A._sdpa(q, k, v, None, cfg.n_heads // cfg.n_kv)
    return B.dense(p["wo"], out)


def _port_tree(tree: Params, device, weight_dtype) -> Params:
    """A tree in this layout with each leaf on ``device``: the layernorms
    f32, every other leaf ``weight_dtype``."""
    def ld(t, path=()):
        return load_tree(t, device, path=path, weight_dtype=weight_dtype)
    return {"embedding": ld(tree["embedding"]), "dec_pos": ld(tree["dec_pos"]),
            "enc": [ld(p) for p in tree["enc"]],
            "dec": [ld(p) for p in tree["dec"]],
            "enc_norm": ld(tree["enc_norm"], ("enc_norm",)),
            "dec_norm": ld(tree["dec_norm"], ("dec_norm",))}


def from_reference(cfg: ArchConfig, tree: Params) -> Params:
    """The reference's tree (``enc`` and ``dec`` stacked on axis 0, its
    vmapped init) in this layout, one dict a layer, the leaves as they
    are."""
    return {**tree,
            "enc": [unstack(tree["enc"], i) for i in range(cfg.enc_layers)],
            "dec": [unstack(tree["dec"], i) for i in range(cfg.n_layers)]}


def to_reference(cfg: ArchConfig, tree: Params) -> Params:
    """A tree in this layout (the params, or a moment) in the reference's
    stacked one, as CPU tensors of the leaves' own dtypes."""
    return {**{k: to_cpu(v) for k, v in tree.items()
               if k not in ("enc", "dec")},
            "enc": stack(tree["enc"]), "dec": stack(tree["dec"])}


def params_from_numpy(cfg: ArchConfig, tree: Params, *, device="cuda",
                      weight_dtype=WEIGHT_DTYPE,
                      remat: bool = False) -> EncDec:
    """An ``EncDec`` on ``device`` with the weights of the reference's param
    pytree, given as numpy arrays or tensors: ``enc`` and ``dec``, stacked
    on axis 0 (the reference's vmapped init), are unstacked into one dict a
    layer. The layernorms become f32, every other leaf ``weight_dtype``."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return EncDec(cfg, _port_tree(from_reference(cfg, tree), dev,
                                  weight_dtype), remat=remat)
