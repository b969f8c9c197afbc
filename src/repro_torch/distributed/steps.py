"""Train / serve step builders: the JAX package's
``src/repro/distributed/steps.py`` on one device.

``make_train_step`` returns ``step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss (token-mean cross entropy plus 1e-2 times
the MoE Switch loss) and its gradient through autograd, then one AdamW
update, in place on the model's weights. Attention there runs the
reference's own functions (``models.attention``), never K5, which has no
backward. ``make_prefill`` and ``make_decode_step`` run under
``torch.inference_mode()``, so the prefill's attention is K5.

Batches follow the reference: ``tokens``/``labels`` (LM), plus ``frames``
(whisper's stub frame embeddings) or ``embeds`` (qwen2-vl's stub patch
embeddings, in place of the tokens); numpy arrays or tensors, moved to the
step's device.

The mesh's parts of the reference's module (``_make_constrain``, the
vocab-sharded logits, ``input_specs``, ``cache_specs``,
``batch_shardings``) are the identity on one device; they come with the
mesh (ROADMAP M10).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import optim, resolve_device
from repro_torch._tree import leaves, unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.data import place

Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy, in f32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _forward(cfg: ArchConfig, model, batch: Batch):
    if cfg.enc_layers:
        return model(batch["tokens"], batch["frames"])
    if cfg.frontend == "vision_stub":
        return model(None, embeds=batch["embeds"])
    return model(batch["tokens"])


def loss_and_grads(cfg: ArchConfig, model, batch: Batch
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(loss, ce, the gradient of the loss for every leaf of
    ``model.params()`` in order); a leaf the loss does not reach gets
    zeros, as the reference's gradient has. The weights require grad for
    the call only; the model's ``remat`` decides the checkpointing."""
    params = leaves(model.params())
    frozen = [not p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        with torch.enable_grad():
            logits, aux = _forward(cfg, model, batch)
            ce = softmax_xent(logits, batch["labels"])
            loss = ce + 1e-2 * aux
            del logits
            grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        for p, f in zip(params, frozen):
            if f:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss.detach(), ce.detach(), grads


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, ocfg: optim.AdamWConfig, *,
                    accum: int = 1, device="cuda") -> Callable:
    """(model, opt_state, batch) -> (model, opt_state, metrics), the model's
    weights and the state's moments updated in place.

    The reference's ``remat`` is the model's own here, set where it is
    built (``build(cfg, remat=True)``): the port's step takes a model with
    its weights, where the reference's builds a weightless one.
    ``accum > 1`` splits the batch into ``accum`` microbatches of
    consecutive rows and averages their gradients (summed in f32), loss and
    ce, as the reference's ``lax.scan`` does. ``metrics``: loss, ce, lr and
    grad_norm (before clipping), 0-d tensors on the device.
    """
    dev = resolve_device(device)

    def train_step(model, opt_state, batch):
        batch = place(batch, dev)
        params = model.params()
        if accum == 1:
            loss, ce, grads = loss_and_grads(cfg, model, batch)
        else:
            n = next(v for v in batch.values() if v is not None).shape[0]
            if n % accum:
                raise ValueError(f"batch {n} does not split into {accum}")
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            csum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                mb = {k: None if v is None else v.reshape(
                    accum, n // accum, *v.shape[1:])[i]
                    for k, v in batch.items()}
                l, c, g = loss_and_grads(cfg, model, mb)
                for acc, gi in zip(gsum, g):
                    acc.add_(gi)
                lsum, csum = lsum + l, csum + c
                del g
            grads = [g / accum for g in gsum]
            loss, ce = lsum / accum, csum / accum
        _, opt2, metrics = optim.update(ocfg, unflatten(params, grads),
                                        opt_state, params)
        metrics.update({"loss": loss, "ce": ce})
        return model, opt2, metrics

    return train_step


def make_prefill(cfg: ArchConfig, *, device="cuda") -> Callable:
    """(model, batch) -> logits: the full-sequence forward (inference
    prefill) under ``torch.inference_mode()``, so its attention is K5."""
    dev = resolve_device(device)

    def prefill(model, batch):
        with torch.inference_mode():
            logits, _ = _forward(cfg, model, place(batch, dev))
        return logits

    return prefill


def make_decode_step(cfg: ArchConfig) -> Callable:
    """(model, token, cache) -> (logits, cache): one serve_step token under
    ``torch.inference_mode()``."""

    def decode(model, token, cache):
        with torch.inference_mode():
            return model.decode_step(token, cache)

    return decode


__all__ = ["softmax_xent", "loss_and_grads", "make_train_step",
           "make_prefill", "make_decode_step"]
