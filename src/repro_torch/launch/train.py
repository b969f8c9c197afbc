"""End-to-end training driver: the JAX package's ``src/repro/launch/train.py``.

Trains any LM ``--arch`` (the reduced config unless ``--full``) on the
synthetic bigram stream with the substrate engaged: the host mesh
(``make_host_mesh``) with the planner's shardings (the weights and AdamW's
moments DTensors by ``params_sharding``, the batches by ``batch_sharding``
through the ``Prefetcher``), f32 weights and AdamW (the reference's param
dtype), remat of each pattern group, async atomic checkpointing with
auto-resume in the reference's format (full tensors of the DTensor leaves,
so a checkpoint of either package resumes in the other), and the step
watchdog (hang detection and straggler counting).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --steps 200 --batch 16 --seq 128 --ckpt-dir build/ckpt

It runs on the GPU unless ``--device cpu``; the mesh is one rank's (a
process on its own: ``("data", "model")`` of shape (1, 1)) unless a process
group of more ranks is running. The reference's docstring promises int8
gradient compression across pods, which its ``main()`` never calls; this
driver does not call it either (``distributed.compression``). Like the
reference, it refuses the encoder-decoder and stub-frontend archs.
"""
from __future__ import annotations

import argparse
import itertools
import time
from typing import Optional, Sequence

import torch

from repro_torch import ckpt as ckpt_lib
from repro_torch import optim, resolve_device
from repro_torch.configs import ARCH_NAMES, get, get_reduced
from repro_torch.data import BigramSampler, LMDataConfig, Prefetcher
from repro_torch.distributed import steps as steps_lib
from repro_torch.distributed.ft import StepWatchdog, WatchdogConfig
from repro_torch.distributed.planner import (PlanConfig, params_sharding,
                                             shard_model, shard_tensor)
from repro_torch.launch.mesh import axis_sizes, batch_sharding, make_host_mesh
from repro_torch.models import (build, params_from_numpy, state_from_numpy,
                                state_to_reference, to_reference)
from repro_torch._tree import tree_map


def _ckpt_tree(cfg, model, opt_state):
    """(params, opt_state) in the reference's layout: a fresh copy on the
    host (the full tensor of each DTensor leaf), which the checkpointer
    takes as it is."""
    return (to_reference(cfg, model.params()),
            state_to_reference(cfg, opt_state))


def _state_on_mesh(cfg, state, mesh, plan):
    """An AdamW state whose moments are put on ``mesh`` as the weights they
    mirror (``params_sharding``)."""
    def on(tree):
        return tree_map(shard_tensor, tree,
                        params_sharding(tree, mesh, plan, cfg=cfg))
    return state._replace(mu=on(state.mu), nu=on(state.nu))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``losses`` (one a logged step), ``last_step``,
    ``resumed_from`` (the restored step, or None), ``stragglers``,
    ``saved_steps``, the trained ``model`` and ``opt_state``, and
    ``restored``: the (params, opt_state) read back on resume, in the
    reference's layout (None without resume)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="xlstm-350m")
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config (needs a GPU)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get(args.arch) if args.full else get_reduced(args.arch)
    if cfg.enc_layers or cfg.frontend != "none":
        raise SystemExit("train.py drives LM archs; use examples/ for "
                         "frontend-stub archs")
    mesh = make_host_mesh(device=dev)
    plan = PlanConfig()
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} on {dev}, mesh {axis_sizes(mesh)}")

    model = shard_model(build(cfg, device=dev, seed=args.seed, remat=True,
                              weight_dtype=torch.float32), mesh, plan)
    ocfg = optim.AdamWConfig(lr=args.lr, warmup_steps=20,
                             total_steps=args.steps)
    train_step = steps_lib.make_train_step(cfg, ocfg, mesh=mesh, plan=plan,
                                           accum=args.accum, device=dev)
    opt_state = optim.init(model.params())
    start_step, restored = 0, None

    # --- auto-resume from the newest committed checkpoint ------------------
    checkpointer = None
    if args.ckpt_dir:
        checkpointer = ckpt_lib.AsyncCheckpointer(args.ckpt_dir, keep=3)
        last = ckpt_lib.latest_step(args.ckpt_dir)
        if last is not None:
            restored, start_step, _ = ckpt_lib.restore(
                args.ckpt_dir, _ckpt_tree(cfg, model, opt_state))
            del model, opt_state
            model = shard_model(params_from_numpy(
                cfg, restored[0], device=dev, weight_dtype=torch.float32,
                remat=True), mesh, plan)
            opt_state = _state_on_mesh(cfg, state_from_numpy(
                cfg, restored[1], device=dev), mesh, plan)
            print(f"[train] resumed from step {start_step}")

    data = BigramSampler(LMDataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      seed=args.seed))
    stream = Prefetcher(
        ({"tokens": t, "labels": l} for t, l in itertools.islice(
            data.stream(args.batch, start_seed=start_step + 1),
            max(0, args.steps - start_step))),
        device=dev, sharding=batch_sharding(mesh))

    wd = StepWatchdog(WatchdogConfig(min_timeout_s=600.0))
    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = next(stream)
        with wd.step():
            model, opt_state, metrics = train_step(model, opt_state, batch)
        if (step + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"[train] step {step + 1}: loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0) / args.log_every:.2f} s/step)")
            t0 = time.time()
        if checkpointer and (step + 1) % args.ckpt_every == 0:
            checkpointer.maybe_save(step + 1,
                                    _ckpt_tree(cfg, model, opt_state))
    if checkpointer:
        checkpointer.maybe_save(args.steps, _ckpt_tree(cfg, model, opt_state))
        checkpointer.wait()
    print(f"[train] done. stragglers observed: {wd.stragglers}")
    if len(losses) >= 2:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    return {"losses": losses, "last_step": args.steps,
            "resumed_from": start_step if restored is not None else None,
            "stragglers": wd.stragglers,
            "saved_steps": list(checkpointer.saved_steps)
            if checkpointer else [],
            "model": model, "opt_state": opt_state, "restored": restored}


if __name__ == "__main__":
    main()
