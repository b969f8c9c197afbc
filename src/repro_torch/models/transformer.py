"""Decoder-only model assembled from an ArchConfig: the JAX package's
``src/repro/models/transformer.py`` — dense (qwen3, granite, qwen1.5), MoE
with a sliding window (mixtral) or a shared expert (llama4), MLA
(minicpm3), the VLM backbone with M-RoPE (qwen2-vl), the RG-LRU hybrid
with local attention (recurrentgemma) and xLSTM (mLSTM and sLSTM blocks)
— the full-sequence forward (training and prefill) and one-token decode.

The reference scans over groups of layers with stacked parameters; here
``Transformer.layers`` is a ``ModuleList`` with one entry a block, in the
order the scan visits them (group by group, the pattern within a group,
then the tail), and ``remat`` checkpoints each pattern group as the
reference's ``checkpoint`` of its scanned group function does. For serving,
the matmul weights and the embedding are held in bf16 on the device (the
reference casts its f32 weights to bf16 at every use, so the function is
the same); the leaves the reference uses in f32 stay f32 (``leaf_is_f32``).
Training holds every leaf in f32 (``weight_dtype=torch.float32``), the
reference's own param dtype, so that AdamW updates the weights the
reference updates.

``to_reference`` and ``from_reference`` move a tree (the params, or a
moment of the optimizer) between this layout and the reference's stacked
one (``groups`` / ``tail``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from . import attention as A
from . import blocks as B
from . import moe as M
from . import recurrent as R

Params = Dict[str, Any]

KINDS = ("attn", "attn_moe", "mla", "rglru", "mlstm", "slstm")
#: Param keys kept f32 wherever they stand, as dicts (the norms' scales and
#: biases, the mLSTM's ``norm``, whisper's ``ln3`` and final norms) or
#: leaves (the MoE router: a bf16 router would change which experts top-k
#: picks).
F32_KEYS = ("ln1", "ln2", "ln3", "qnorm", "knorm", "q_norm", "kv_norm",
            "final_norm", "enc_norm", "dec_norm", "norm", "router")
#: Leaves kept f32 in one block kind only, as key paths within the block:
#: the reference uses RG-LRU's ``lam`` and the sLSTM's six gate matrices
#: in f32. The names alone cannot decide: ``wi`` and ``wf`` are also the
#: mLSTM's gates and the GELU MLP's input, bf16 dense weights both.
F32_PATHS = {
    "rglru": (("rglru", "lam"),),
    "slstm": tuple(("core", g) for g in R.SLSTM_GATES + R.SLSTM_RECURRENT),
}
WEIGHT_DTYPE = torch.bfloat16


def leaf_is_f32(kind: Optional[str], path: Tuple[str, ...]) -> bool:
    """Whether the leaf at ``path`` (keys from the block's dict, or from the
    model's top level with ``kind`` None) is held f32; every other leaf is
    a matmul weight, bias, conv kernel or embedding, held in
    WEIGHT_DTYPE."""
    return (any(k in F32_KEYS for k in path)
            or any(path[:len(pre)] == pre for pre in F32_PATHS.get(kind, ())))


def check_kind(kind: str) -> None:
    """Raises ValueError for a block kind this module does not know."""
    if kind not in KINDS:
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


def _mla_cfg(cfg: ArchConfig) -> A.MLAConfig:
    m = cfg.mla
    return A.MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                       q_lora_rank=m.q_lora_rank, kv_lora_rank=m.kv_lora_rank,
                       qk_nope_dim=m.qk_nope_dim, qk_rope_dim=m.qk_rope_dim,
                       v_head_dim=m.v_head_dim, rope_theta=cfg.rope_theta)


def _moe_cfg(cfg: ArchConfig) -> M.MoEConfig:
    return M.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       n_experts=cfg.n_experts, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       shared_expert=cfg.shared_expert)


def _rglru_cfg(cfg: ArchConfig) -> R.RGLRUConfig:
    return R.RGLRUConfig(d_model=cfg.d_model)


def _mlstm_cfg(cfg: ArchConfig) -> R.MLSTMConfig:
    return R.MLSTMConfig(d_model=cfg.d_model, n_heads=cfg.slstm_heads,
                         chunk=cfg.mlstm_chunk)


def _slstm_cfg(cfg: ArchConfig) -> R.SLSTMConfig:
    return R.SLSTMConfig(d_model=cfg.d_model, n_heads=cfg.slstm_heads)


def _norm_init(cfg: ArchConfig, device=None):
    return (B.rmsnorm_init if cfg.norm_kind == "rms"
            else B.layernorm_init)(cfg.d_model, device=device)


def _norm(cfg: ArchConfig, p, x):
    return (B.rmsnorm if cfg.norm_kind == "rms" else B.layernorm)(p, x)


def _mlp_init(gen, cfg: ArchConfig, device, dtype=WEIGHT_DTYPE):
    return (B.swiglu_init if cfg.mlp_kind == "swiglu"
            else B.gelu_mlp_init)(gen, cfg.d_model, cfg.d_ff,
                                  dtype=dtype, device=device)


def _mlp(cfg: ArchConfig, p, x):
    return (B.swiglu if cfg.mlp_kind == "swiglu" else B.gelu_mlp)(p, x)


# ---------------------------------------------------------------------------
# block init / apply / cache / decode — dispatch on kind
# ---------------------------------------------------------------------------

def block_init(gen, kind: str, cfg: ArchConfig, device=None,
               weight_dtype=WEIGHT_DTYPE) -> Params:
    check_kind(kind)
    kw = dict(dtype=weight_dtype, device=device)
    if kind == "mlstm":
        return {"ln1": _norm_init(cfg, device),
                "core": R.mlstm_init(gen, _mlstm_cfg(cfg), **kw)}
    if kind == "slstm":
        return {"ln1": _norm_init(cfg, device),
                "core": R.slstm_init(gen, _slstm_cfg(cfg), **kw)}
    if kind == "mla":
        mixer = {"mla": A.mla_init(gen, _mla_cfg(cfg), **kw)}
    elif kind == "rglru":
        mixer = {"rglru": R.rglru_init(gen, _rglru_cfg(cfg), **kw)}
    else:
        mixer = {"attn": A.attn_init(gen, _attn_cfg(cfg), **kw)}
    if kind == "attn_moe":
        ffn = {"moe": M.moe_init(gen, _moe_cfg(cfg), **kw)}
    else:
        ffn = {"mlp": _mlp_init(gen, cfg, device, weight_dtype)}
    return {"ln1": _norm_init(cfg, device), **mixer,
            "ln2": _norm_init(cfg, device), **ffn}


def _ffn(kind: str, p: Params, h: torch.Tensor, cfg: ArchConfig):
    """The block's second half on the normed h: (out, aux)."""
    if kind == "attn_moe":
        return M.moe_forward(p["moe"], h, _moe_cfg(cfg))
    return _mlp(cfg, p["mlp"], h), _zero(h)


def _zero(x: torch.Tensor) -> torch.Tensor:
    """A block's aux loss where it has none."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_apply(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence residual block. Returns (x, aux_loss)."""
    check_kind(kind)
    h = _norm(cfg, p["ln1"], x)
    if kind == "mlstm":
        return x + R.mlstm_block(p["core"], h, _mlstm_cfg(cfg)), _zero(x)
    if kind == "slstm":
        return x + R.slstm_block(p["core"], h, _slstm_cfg(cfg)), _zero(x)
    if kind == "mla":
        # MLA's RoPE takes one position stream: M-RoPE's first (temporal)
        if positions is not None and positions.dim() == 3:
            positions = positions[..., 0]
        x = x + A.mla_attention(p["mla"], h, _mla_cfg(cfg), positions)
    elif kind == "rglru":
        x = x + R.rglru_block(p["rglru"], h, _rglru_cfg(cfg))
    else:
        x = x + A.attention(p["attn"], h, _attn_cfg(cfg), positions)
    out, aux = _ffn(kind, p, _norm(cfg, p["ln2"], x), cfg)
    return x + out, aux


def block_cache_init(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                     device=None):
    check_kind(kind)
    if kind == "mla":
        return A.mla_init_cache(_mla_cfg(cfg), batch, max_len, device=device)
    if kind == "rglru":
        return R.rglru_init_state(_rglru_cfg(cfg), batch, device=device)
    if kind == "mlstm":
        return R.mlstm_init_state(_mlstm_cfg(cfg), batch, device=device)
    if kind == "slstm":
        return R.slstm_init_state(_slstm_cfg(cfg), batch, device=device)
    acfg = _attn_cfg(cfg)
    # sliding-window caches are ring buffers of size window
    n = min(max_len, acfg.window) if acfg.window else max_len
    return A.init_cache(acfg, batch, n, device=device)


def block_decode(kind: str, p: Params, x: torch.Tensor, cache,
                 cfg: ArchConfig):
    check_kind(kind)
    h = _norm(cfg, p["ln1"], x)
    if kind == "mlstm":
        h, cache = R.mlstm_step(p["core"], h, cache, _mlstm_cfg(cfg))
        return x + h, cache, _zero(x)
    if kind == "slstm":
        h, cache = R.slstm_step(p["core"], h, cache, _slstm_cfg(cfg))
        return x + h, cache, _zero(x)
    if kind == "mla":
        h, cache = A.mla_decode_step(p["mla"], h, cache, _mla_cfg(cfg))
    elif kind == "rglru":
        h, cache = R.rglru_step(p["rglru"], h, cache, _rglru_cfg(cfg))
    else:
        h, cache = A.decode_step(p["attn"], h, cache, _attn_cfg(cfg))
    x = x + h
    out, aux = _ffn(kind, p, _norm(cfg, p["ln2"], x), cfg)
    return x + out, cache, aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested dict of tensors as a module, read with ``p[key]`` and
    ``key in p`` as the blocks read a dict; a dict may hold both tensors and
    sub-dicts (llama4's ``moe``: the stacked experts beside the ``shared``
    SwiGLU). The tensors are shared (not copied) and frozen by default, so
    that serving builds no graph; training turns gradients on with
    ``requires_grad_(True)`` (``distributed.steps``)."""

    def __init__(self, tree: Params):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))
            else:
                self.add_module(k, _Tree(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> Params:
        """The nested dict of the parameters themselves (not copies)."""
        return {**self._parameters,
                **{k: m.tree() for k, m in self._modules.items()}}


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """The block kinds in the order the reference's scan visits them."""
    return list(cfg.pattern) * cfg.n_groups + list(cfg.pattern_tail)


def init_params(cfg: ArchConfig, *, device, seed: int = 0,
                weight_dtype=WEIGHT_DTYPE) -> Params:
    """Random weights on ``device`` as the reference's ``_init`` scales them
    (1/sqrt of the first axis: d_in for a matrix, the expert count for a
    stacked expert weight; 1.0 for the embedding; 0.3 for RG-LRU's conv;
    its ``lam`` is the reference's fixed one), from a ``torch.Generator``
    seeded with ``seed``; drawn f32 one tensor (one expert) at a time and
    cast to ``weight_dtype``, the leaves of ``leaf_is_f32`` kept f32. The
    numbers differ from the JAX package's for the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"embedding": B.embedding_init(gen, cfg.vocab, cfg.d_model,
                                          dtype=weight_dtype, device=device),
            "final_norm": _norm_init(cfg, device),
            "layers": [block_init(gen, kind, cfg, device=device,
                                  weight_dtype=weight_dtype)
                       for kind in layer_kinds(cfg)]}


class Transformer(nn.Module):
    """The model bound to an ArchConfig and its weights.

    ``params`` is ``{"embedding", "final_norm", "layers": [one dict a
    block]}`` (``init_params``; ``params_from_numpy`` for the reference's
    pytree). The tensors are used as given, not copied. ``remat``
    checkpoints each pattern group of a forward that carries a gradient.
    """

    def __init__(self, cfg: ArchConfig, params: Params, *,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.kinds = layer_kinds(cfg)
        if len(params["layers"]) != len(self.kinds):
            raise ValueError(f"{len(params['layers'])} layers of params for "
                             f"{len(self.kinds)} blocks")
        for k in self.kinds:
            check_kind(k)
        self.embedding = _Tree(params["embedding"])
        self.final_norm = _Tree(params["final_norm"])
        self.layers = nn.ModuleList(_Tree(p) for p in params["layers"])

    @property
    def device(self) -> torch.device:
        return self.embedding["emb"].device

    def params(self) -> Params:
        """The weights in this layout, the tensors themselves: the tree
        the optimizer updates in place."""
        return {"embedding": self.embedding.tree(),
                "final_norm": self.final_norm.tree(),
                "layers": [p.tree() for p in self.layers]}

    def cast(self, weight_dtype) -> "Transformer":
        """A copy of the model with its weights in ``weight_dtype`` (a leaf
        of ``leaf_is_f32`` stays f32), frozen."""
        return Transformer(self.cfg, _port_tree(self.cfg, self.params(),
                                                self.device, weight_dtype),
                           remat=self.remat)

    # -- full-sequence forward (train / prefill) ------------------------------
    def forward(self, tokens: Optional[torch.Tensor],
                embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) f32, aux loss scalar). ``embeds``
        overrides the token embedding (stub frontends). The model's
        ``remat`` checkpoints each pattern group when grad mode is on; the
        tail's blocks are not checkpointed, as in the reference."""
        cfg = self.cfg
        remat = self.remat and torch.is_grad_enabled()
        x = embeds if embeds is not None else B.embed(self.embedding, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n = len(cfg.pattern)
        n_body = cfg.n_groups * n
        for g0 in range(0, n_body, n):
            group = list(zip(self.kinds[g0:g0 + n], self.layers[g0:g0 + n]))
            if remat:
                x, a = checkpoint(_group_apply, group, x, cfg, positions,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _group_apply(group, x, cfg, positions)
            aux = aux + a
        for kind, p in zip(self.kinds[n_body:], self.layers[n_body:]):
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


def _group_apply(group, x: torch.Tensor, cfg: ArchConfig,
                 positions: Optional[torch.Tensor]):
    """One pattern group's blocks in turn: (x, the group's aux loss)."""
    aux = _zero(x)
    for kind, p in group:
        x, a = block_apply(kind, p, x, cfg, positions)
        aux = aux + a
    return x, aux


def as_tensor(a) -> torch.Tensor:
    """A tensor as it is, or a copy of a numpy array as a CPU tensor of its
    dtype (a bf16 array, as JAX hands it out, by its bytes)."""
    if isinstance(a, torch.Tensor):
        return a
    arr = np.array(a, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_tree(tree, device, kind: Optional[str] = None,
              path: Tuple[str, ...] = (), weight_dtype=WEIGHT_DTYPE):
    """A nested dict of numpy arrays (through f32) or tensors as new
    tensors on ``device``: f32 where ``leaf_is_f32(kind, path + keys)``,
    ``weight_dtype`` elsewhere."""
    if isinstance(tree, dict):
        return {k: load_tree(v, device, kind, path + (k,), weight_dtype)
                for k, v in tree.items()}
    t = (tree.detach() if isinstance(tree, torch.Tensor)
         else torch.from_numpy(np.array(tree, dtype=np.float32)))
    return t.to(device, torch.float32 if leaf_is_f32(kind, path)
                else weight_dtype, copy=True)


def unstack(tree, i: int):
    """Entry ``i`` along axis 0 of every leaf of a stacked pytree."""
    if isinstance(tree, dict):
        return {k: unstack(v, i) for k, v in tree.items()}
    return tree[i]


def stack(trees: List[Params]) -> Params:
    """The dicts of ``trees`` with every leaf stacked on a new axis 0, on
    the CPU (the reference's vmapped layout)."""
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([as_tensor(t).detach().cpu() for t in trees])


def to_cpu(tree) -> Params:
    """A copy of a nested dict of tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return as_tensor(tree).detach().to("cpu", copy=True)


def _port_tree(cfg: ArchConfig, tree: Params, device,
               weight_dtype) -> Params:
    """A tree in this layout with each leaf on ``device``, in f32 or
    ``weight_dtype`` by ``leaf_is_f32``."""
    return {"embedding": load_tree(tree["embedding"], device,
                                   weight_dtype=weight_dtype),
            "final_norm": load_tree(tree["final_norm"], device,
                                    path=("final_norm",)),
            "layers": [load_tree(p, device, kind, weight_dtype=weight_dtype)
                       for p, kind in zip(tree["layers"], layer_kinds(cfg))]}


def from_reference(cfg: ArchConfig, tree: Params) -> Params:
    """The reference's stacked tree (``groups`` unstacked along axis 0 into
    the layers, then ``tail``) in this layout, the leaves as they are."""
    blocks = [unstack(tree["groups"], g)[f"b{i}"]
              for g in range(cfg.n_groups) for i in range(len(cfg.pattern))]
    blocks += list(tree.get("tail", []))
    return {"embedding": tree["embedding"], "final_norm": tree["final_norm"],
            "layers": blocks}


def to_reference(cfg: ArchConfig, tree: Params) -> Params:
    """A tree in this layout (the params, or a moment) in the reference's
    stacked layout, as CPU tensors of the leaves' own dtypes: ``groups``
    (``b{i}``, each leaf stacked over the groups) and ``tail`` where the
    pattern has one."""
    n = len(cfg.pattern)
    layers = tree["layers"]
    out = {"embedding": to_cpu(tree["embedding"]),
           "final_norm": to_cpu(tree["final_norm"]),
           "groups": {f"b{i}": stack(layers[i:cfg.n_groups * n:n])
                      for i in range(n)}}
    if cfg.pattern_tail:
        out["tail"] = [to_cpu(p) for p in layers[cfg.n_groups * n:]]
    return out


def params_from_numpy(cfg: ArchConfig, tree: Params, *, device="cuda",
                      weight_dtype=WEIGHT_DTYPE,
                      remat: bool = False) -> Transformer:
    """A ``Transformer`` on ``device`` with the weights of the reference's
    param pytree, given as numpy arrays or tensors: ``groups`` is
    unstacked along axis 0 into the layers, then ``tail``. Each leaf is
    f32 or ``weight_dtype`` by ``leaf_is_f32``, from its block kind and key
    path."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return Transformer(cfg, _port_tree(cfg, from_reference(cfg, tree), dev,
                                       weight_dtype), remat=remat)
