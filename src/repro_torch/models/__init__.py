"""Model zoo: the float jet models (MLP, DeepSets) in the JAX package's
layout, and the LM substrate (``blocks``, ``attention``, ``moe``,
``transformer``) behind ``build``: the dense, MoE, MLA and VLM-backbone
families."""
from . import attention, blocks, deepsets, mlp, moe, transformer
from .deepsets import DeepSets
from .mlp import MLP
from .transformer import Transformer, init_params, params_from_numpy


def _refuse(cfg) -> None:
    """Raises NotImplementedError for what the port cannot build yet, with
    the ROADMAP item that ports it."""
    if cfg.enc_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet: "
            "ROADMAP.md §1 M9c (encdec)")
    for kind in (*cfg.pattern, *cfg.pattern_tail):
        transformer.check_kind(kind)


def build(cfg, *, device="cuda", seed: int = 0) -> Transformer:
    """ArchConfig -> a ``Transformer`` with random weights from ``seed`` on
    ``device`` (CUDA unless the caller asks for the CPU). The attention,
    MoE and MLA kinds, with or without a window or M-RoPE; the recurrent
    kinds and the encoder-decoder raise NotImplementedError."""
    from repro_torch import resolve_device
    _refuse(cfg)
    dev = resolve_device(device)
    return Transformer(cfg, init_params(cfg, device=dev, seed=seed))


__all__ = ["attention", "blocks", "deepsets", "mlp", "moe", "transformer",
           "DeepSets", "MLP", "Transformer", "build", "init_params",
           "params_from_numpy"]
