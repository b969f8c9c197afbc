"""Model zoo: the float jet models (MLP, DeepSets) in the JAX package's
layout, and the LM substrate (``blocks``, ``attention``, ``moe``,
``recurrent``, ``transformer``, ``encdec``) behind ``build``: all ten
architectures of ``configs`` — the dense, MoE, MLA, VLM-backbone, RG-LRU
hybrid and xLSTM families as a ``Transformer``, whisper as an
``EncDec``."""
from . import (attention, blocks, deepsets, encdec, mlp, moe, recurrent,
               transformer)
from .deepsets import DeepSets
from .encdec import EncDec
from .mlp import MLP
from .transformer import Transformer, init_params


def build(cfg, *, device="cuda", seed: int = 0):
    """ArchConfig -> a model with random weights from ``seed`` on
    ``device`` (CUDA unless the caller asks for the CPU): an ``EncDec``
    when ``cfg.enc_layers > 0``, else a ``Transformer``."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if cfg.enc_layers > 0:
        return EncDec(cfg, encdec.init_params(cfg, device=dev, seed=seed))
    return Transformer(cfg, init_params(cfg, device=dev, seed=seed))


def params_from_numpy(cfg, tree, *, device="cuda"):
    """The model for ``cfg`` on ``device`` with the weights of the
    reference's param pytree (numpy arrays): ``encdec.params_from_numpy``
    when ``cfg.enc_layers > 0``, else ``transformer.params_from_numpy``."""
    mod = encdec if cfg.enc_layers > 0 else transformer
    return mod.params_from_numpy(cfg, tree, device=device)


__all__ = ["attention", "blocks", "deepsets", "encdec", "mlp", "moe",
           "recurrent", "transformer", "DeepSets", "EncDec", "MLP",
           "Transformer", "build", "init_params", "params_from_numpy"]
