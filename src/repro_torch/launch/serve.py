"""μs-scale jet-tagging serving driver — the paper's deployment scenario.

Trains a small MLP or DeepSets tagger on the synthetic jet stream (float32,
plain SGD), quantizes it to the paper's INT8 power-of-two scheme, deploys it
behind the batching ``JetServer`` running the fused cascade kernel on the
GPU, and reports:

  * classification accuracy float vs INT8 (quantization cost),
  * per-event latency percentiles with events sent one at a time,
  * events per second for the same events sent at once (a burst that the
    server batches, up to 64 events a launch), whose outputs must equal the
    one-at-a-time outputs bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.serve --model deepsets-32
    PYTHONPATH=src python -m repro_torch.launch.serve --model jsc-m --mode unfused
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --events 8

``main`` returns the run's numbers, the quantized model and the served
outputs, so that a caller can hold them against the plain versions.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data import JetConfig, jet_batch
from repro_torch.models import deepsets as ds
from repro_torch.models import mlp as mlp_lib
from repro_torch.serve import JetServer

MODELS = {
    "jsc-m": dict(kind="mlp", M=64, F=16, nodes=[64, 32, 32, 32, 5]),
    "jsc-xl": dict(kind="mlp", M=64, F=16, nodes=[128, 64, 64, 64, 5]),
    "deepsets-32": dict(kind="deepsets", M=32, F=21,
                        phi=[32, 32, 32], rho=[32, 10]),
    "deepsets-64": dict(kind="deepsets", M=64, F=21,
                        phi=[64, 64, 64], rho=[64, 10]),
}
LR = 2e-2


def _train(m: dict, n_classes: int, *, steps: int, seed: int,
           device: torch.device):
    jc = JetConfig(n_particles=m["M"], n_features=m["F"], n_classes=n_classes,
                   seed=seed)
    g = torch.Generator().manual_seed(seed)
    if m["kind"] == "mlp":
        model = mlp_lib.mlp_init(m["F"], m["nodes"], generator=g, device=device)
        loss_fn = mlp_lib.mlp_loss
    else:
        model = ds.deepsets_init(m["F"], m["phi"], m["rho"], generator=g,
                                 device=device)
        loss_fn = ds.deepsets_loss
    params = list(model.parameters())
    for step in range(steps):
        x, y = jet_batch(jc, 256, step + 1)
        loss = loss_fn(model, torch.from_numpy(x).to(device),
                       torch.from_numpy(y).to(device))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, gr in zip(params, grads):
                p.sub_(LR * gr)
        if (step + 1) % 100 == 0:
            print(f"[serve] train step {step + 1}: loss {loss.item():.4f}")
    return model, jc


def _predict(scores: np.ndarray, n_classes: int) -> int:
    """Class of one served event from the row-mean of its int8 scores (one
    row for DeepSets, M rows for an MLP), as the float path does."""
    s = scores.reshape(-1, scores.shape[-1])[:, :n_classes]
    return int(np.argmax(s.astype(np.float64).mean(axis=0)))


def _prepare(name: str, *, train_steps: int, seed: int, device: torch.device
             ) -> dict:
    """Train + quantize one model; return it with its eval context."""
    m = MODELS[name]
    n_classes = m["nodes"][-1] if m["kind"] == "mlp" else m["rho"][-1]
    model, jc = _train(m, n_classes, steps=train_steps, seed=seed,
                       device=device)
    xcal, _ = jet_batch(jc, 512, 12345)
    if m["kind"] == "mlp":
        qmlp, rho = mlp_lib.to_quantized(model, xcal), None
        float_fn = lambda x: model(x).mean(dim=1)
    else:
        qmlp, rho = ds.to_quantized(model, xcal)
        float_fn = model
    x, y = jet_batch(jc, 2048, 777)
    with torch.no_grad():
        logits = float_fn(torch.from_numpy(x).to(device))
    acc_float = float((logits.argmax(-1).cpu().numpy() == y).mean())
    return dict(name=name, qmlp=qmlp, rho=rho, jc=jc, n_classes=n_classes,
                acc_float=acc_float)


def _wait(reqs):
    """Waits for every request; raises on a timeout or a failed batch."""
    for r in reqs:
        if not r.event.wait(120):
            raise TimeoutError("inference timed out")
        if r.error is not None:
            raise RuntimeError("serving batch failed") from r.error
    return reqs


def _serve_single(prep: dict, args, device: torch.device) -> dict:
    """Single-instance deployment (one JetServer)."""
    server = JetServer(prep["qmlp"], rho=prep["rho"], agg="mean",
                       mode=args.mode, device=device)
    try:
        x, y = jet_batch(prep["jc"], args.events, 999)
        e_in = prep["qmlp"].e_in
        xq = np.clip(np.round(x / 2.0 ** e_in), -128, 127).astype(np.int8)
        t0 = time.perf_counter()
        singles = [_wait([server.submit(xq[i])])[0] for i in range(args.events)]
        wall = time.perf_counter() - t0
        p50, p99 = server.stats.percentile(50), server.stats.percentile(99)
        n_batches = len(server.stats.batch_sizes)

        t1 = time.perf_counter()
        burst = _wait([server.submit(xq[i]) for i in range(args.events)])
        burst_wall = time.perf_counter() - t1
        burst_batches = server.stats.batch_sizes[n_batches:]
    finally:
        server.close()
    outputs = np.stack([r.result for r in singles])
    if not np.array_equal(outputs, np.stack([r.result for r in burst])):
        raise AssertionError("batched outputs differ from one-at-a-time ones")
    # Where one event's latency goes: the wait for its batch to start, split
    # into the worker's wake-up (submit to dequeue) and the rest of the
    # collection window (dequeue to start), and the batch's service
    # (host-to-device copy, launch, device-to-host copy).
    def p50_us(a, b):
        return float(np.median([(getattr(r, b) - getattr(r, a)) * 1e6
                                for r in singles]))
    wait_p50 = p50_us("t_submit", "t_start")
    dequeue_p50 = p50_us("t_submit", "t_dequeued")
    window_p50 = p50_us("t_dequeued", "t_start")
    service_p50 = p50_us("t_start", "t_done")
    acc_q = float(np.mean([_predict(o, prep["n_classes"]) == y[i]
                           for i, o in enumerate(outputs)]))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    report = dict(model=prep["name"], mode=args.mode, device=where,
                  acc_float=prep["acc_float"], acc_int8=acc_q,
                  p50_us=p50, p99_us=p99, queue_wait_p50_us=wait_p50,
                  dequeue_p50_us=dequeue_p50, window_p50_us=window_p50,
                  service_p50_us=service_p50, events_per_s=args.events / wall,
                  burst_events_per_s=args.events / burst_wall,
                  burst_batches=len(burst_batches),
                  burst_max_batch=max(burst_batches),
                  qmlp=prep["qmlp"], rho=prep["rho"], xq=xq, outputs=outputs)
    print(f"\n[serve] {prep['name']}: float acc {prep['acc_float']:.3f}, "
          f"INT8 acc {acc_q:.3f}")
    print(f"[serve] measured on {where}, mode {args.mode}, one event at a "
          f"time: p50 {p50:.1f} us, p99 {p99:.1f} us, "
          f"{report['events_per_s']:.0f} events/s (p50 wait for a batch "
          f"{wait_p50:.1f} us = dequeue {dequeue_p50:.1f} us + window "
          f"{window_p50:.1f} us; p50 batch service {service_p50:.1f} us)")
    print(f"[serve] burst of {args.events} events: "
          f"{report['burst_events_per_s']:.0f} events/s in "
          f"{len(burst_batches)} batches (largest {max(burst_batches)})")
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=list(MODELS), default="deepsets-32")
    ap.add_argument("--events", type=int, default=256)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--mode", choices=["fused", "unfused"], default="fused",
                    help="unfused: one mm_int8 launch per layer (MLP models; "
                         "DeepSets only with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "PyTorch versions run")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights and the jet stream")
    args = ap.parse_args(argv)
    if args.events < 1:
        ap.error("--events must be >= 1")
    device = resolve_device(args.device)
    if (args.mode == "unfused" and MODELS[args.model]["kind"] == "deepsets"
            and device.type == "cuda"):
        ap.error("DeepSets has no per-layer kernel path; --mode unfused "
                 "serves it only with --device cpu")
    prep = _prepare(args.model, train_steps=args.train_steps, seed=args.seed,
                    device=device)
    return _serve_single(prep, args, device)


if __name__ == "__main__":
    main()
