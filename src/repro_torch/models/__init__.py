"""Model zoo: the float jet models (MLP, DeepSets) in the JAX package's
layout, and the LM substrate (``blocks``, ``attention``, ``moe``,
``recurrent``, ``transformer``, ``encdec``) behind ``build``: all ten
architectures of ``configs`` — the dense, MoE, MLA, VLM-backbone, RG-LRU
hybrid and xLSTM families as a ``Transformer``, whisper as an
``EncDec``.

A model holds its weights in one dict (or list) a layer; the reference
stacks them over its scanned groups. ``params_from_numpy`` and
``params_to_numpy`` carry the weights across, ``state_from_numpy`` and
``state_to_reference`` an AdamW state whose moments mirror them, so that a
checkpoint of either package resumes in the other.
"""
import torch

from . import (attention, blocks, deepsets, encdec, mlp, moe, recurrent,
               transformer)
from .deepsets import DeepSets
from .encdec import EncDec
from .mlp import MLP
from .transformer import WEIGHT_DTYPE, Transformer, init_params


def _layout(cfg):
    return encdec if cfg.enc_layers > 0 else transformer


def build(cfg, *, device="cuda", seed: int = 0, remat: bool = False,
          weight_dtype=WEIGHT_DTYPE):
    """ArchConfig -> a model with random weights from ``seed`` on
    ``device`` (CUDA unless the caller asks for the CPU): an ``EncDec``
    when ``cfg.enc_layers > 0``, else a ``Transformer``. Serving holds the
    matmul weights in ``WEIGHT_DTYPE`` (bf16); training passes
    ``weight_dtype=torch.float32``, the reference's param dtype. ``remat``
    checkpoints each pattern group (each layer of an ``EncDec``) of a
    forward that carries a gradient."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    mod = _layout(cfg)
    cls = EncDec if cfg.enc_layers > 0 else Transformer
    return cls(cfg, mod.init_params(cfg, device=dev, seed=seed,
                                    weight_dtype=weight_dtype), remat=remat)


def params_from_numpy(cfg, tree, *, device="cuda", weight_dtype=WEIGHT_DTYPE,
                      remat: bool = False):
    """The model for ``cfg`` on ``device`` with the weights of the
    reference's param pytree (numpy arrays or tensors):
    ``encdec.params_from_numpy`` when ``cfg.enc_layers > 0``, else
    ``transformer.params_from_numpy``."""
    return _layout(cfg).params_from_numpy(cfg, tree, device=device,
                                          weight_dtype=weight_dtype,
                                          remat=remat)


def to_reference(cfg, tree):
    """A tree in the model's layout (``model.params()``, or a moment of the
    optimizer) in the reference's stacked layout, as CPU tensors of the
    leaves' own dtypes."""
    return _layout(cfg).to_reference(cfg, tree)


def from_reference(cfg, tree, *, device="cuda"):
    """A tree in the reference's stacked layout (numpy arrays or tensors)
    in the model's layout, as new tensors on ``device`` of the leaves' own
    dtypes (a bf16 numpy array by its bytes)."""
    from repro_torch import resolve_device
    from repro_torch._tree import tree_map
    dev = resolve_device(device)
    return tree_map(lambda a: transformer.as_tensor(a).to(dev, copy=True),
                    _layout(cfg).from_reference(cfg, tree))


def params_to_numpy(cfg, model):
    """The inverse of ``params_from_numpy``: the model's weights as the
    reference's param pytree (``groups`` / ``tail``, or whisper's stacked
    ``enc`` / ``dec``), f32 numpy arrays."""
    from repro_torch._tree import tree_map
    return tree_map(lambda t: t.float().numpy(),
                    to_reference(cfg, model.params()))


def state_from_numpy(cfg, state, *, device="cuda"):
    """An ``optim.AdamWState`` whose ``mu``/``nu`` are reference-layout
    trees (numpy arrays or tensors) in the model's layout on ``device``,
    each moment in its own dtype; ``step`` an int32 scalar."""
    from repro_torch.optim import AdamWState
    step = transformer.as_tensor(state.step)
    return AdamWState(step=step.to(device, torch.int32, copy=True),
                      mu=from_reference(cfg, state.mu, device=device),
                      nu=from_reference(cfg, state.nu, device=device))


def state_to_reference(cfg, state):
    """The inverse of ``state_from_numpy``: the moments in the reference's
    stacked layout, CPU tensors of their own dtypes."""
    from repro_torch.optim import AdamWState
    return AdamWState(step=state.step.detach().to("cpu", copy=True),
                      mu=to_reference(cfg, state.mu),
                      nu=to_reference(cfg, state.nu))


__all__ = ["attention", "blocks", "deepsets", "encdec", "mlp", "moe",
           "recurrent", "transformer", "DeepSets", "EncDec", "MLP",
           "Transformer", "build", "init_params", "params_from_numpy",
           "params_to_numpy", "to_reference", "from_reference",
           "state_from_numpy", "state_to_reference"]
