"""μs-scale inference serving runtime (the paper's deployment scenario).

The trigger-system setting: events arrive continuously; each must be
classified within a hard latency budget. The engine mirrors μ-ORCA's
execution model:

  * the whole model runs as ONE fused kernel launch per served batch (the
    cascade analogue), with the per-layer chain as the explicit baseline;
  * requests are micro-batched within a bounded collection window (batching
    amortizes the fixed ingest/launch overheads);
  * the engine reports measured wall-time percentiles.

The quantized weights move to the device once, at construction. A batch of
B events of shape (M, F) is one launch: DeepSets takes (B, M, F) whole, and
an MLP takes the (B*M, F) rows.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.quant import QuantizedMLP
from repro_torch.kernels.cascade_mlp import (cascade_mlp, cascade_mlp_ref,
                                             deepsets, deepsets_ref,
                                             mlp_unfused, prepare)

MODES = ("fused", "unfused", "ref")


@dataclasses.dataclass
class ServeStats:
    latencies_us: List[float] = dataclasses.field(default_factory=list)
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    t_first_submit: Optional[float] = None
    t_last_done: Optional[float] = None

    def record(self, t_submit: float, t_done: float) -> None:
        """Record one completed event and extend the serving window."""
        self.latencies_us.append((t_done - t_submit) * 1e6)
        if self.t_first_submit is None or t_submit < self.t_first_submit:
            self.t_first_submit = t_submit
        if self.t_last_done is None or t_done > self.t_last_done:
            self.t_last_done = t_done

    def percentile(self, p: float) -> float:
        if not self.latencies_us:
            return 0.0
        arr = np.asarray(self.latencies_us)
        # Interpolated tail percentiles under-report on small samples (p99 of
        # 4 events would land below the observed max); once fewer than one
        # sample sits above the requested rank, report the observed max.
        if p >= 50.0 and arr.size * (100.0 - p) < 100.0:
            return float(arr.max())
        return float(np.percentile(arr, p))

    def throughput_eps(self) -> float:
        """Measured events/sec over the first-submit .. last-done window."""
        if self.t_first_submit is None or self.t_last_done is None:
            return 0.0
        span = self.t_last_done - self.t_first_submit
        return len(self.latencies_us) / span if span > 0 else 0.0

    def summary(self) -> dict:
        return {"n": len(self.latencies_us),
                "p50_us": self.percentile(50), "p99_us": self.percentile(99),
                "throughput_eps": self.throughput_eps(),
                "mean_batch": (float(np.mean(self.batch_sizes))
                               if self.batch_sizes else 0.0)}


@dataclasses.dataclass
class _Request:
    x: np.ndarray
    t_submit: float
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    t_done: Optional[float] = None
    t_dequeued: Optional[float] = None
    """When the worker took this request off the queue; the gap from
    ``t_submit`` is the worker's wake-up (and any backlog)."""
    t_start: Optional[float] = None
    """When the serving batch holding this request began executing; the gap
    from ``t_submit`` is the queue wait, the gap from ``t_dequeued`` the rest
    of the collection window."""

    @property
    def latency_us(self) -> float:
        return ((self.t_done - self.t_submit) * 1e6
                if self.t_done is not None else 0.0)

    @property
    def queue_wait_us(self) -> float:
        return ((self.t_start - self.t_submit) * 1e6
                if self.t_start is not None else 0.0)


class JetServer:
    """Batching inference server for quantized MLP / DeepSets jet taggers.

    ``mode``: 'fused' (one cascade kernel launch per batch), 'unfused' (one
    mm_int8 launch per layer), 'ref' (the plain PyTorch versions; the tests'
    bit-exact oracle). DeepSets has no per-layer kernel path: 'unfused' runs
    its plain version, as the JAX package does, and so is refused on CUDA.
    ``device`` defaults to CUDA and raises where there is none.
    """

    def __init__(self, qmlp: QuantizedMLP, *,
                 rho: Optional[QuantizedMLP] = None,
                 agg: str = "mean",
                 mode: str = "fused",
                 max_batch: int = 64,
                 window_us: float = 200.0,
                 device="cuda"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.device = resolve_device(device)
        if rho is not None and mode == "unfused" and self.device.type == "cuda":
            raise ValueError("DeepSets has no per-layer kernel path: mode "
                             "'unfused' would serve its plain version on CUDA")
        self.qmlp = qmlp.to(self.device)
        self.rho = None if rho is None else rho.to(self.device)
        self.agg = agg
        self.mode = mode
        self.max_batch = max_batch
        self.window_us = window_us
        self.stats = ServeStats()
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._fn = self._build()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- model function -------------------------------------------------------
    def _build(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """(B, M, F) int8 on the device -> (B, 1, n_out) for DeepSets,
        (B, M, n_out) for an MLP."""
        q, rho = self.qmlp, self.rho
        if self.mode == "fused":
            prepare(q, rho)
        if rho is not None:
            if self.mode == "fused":
                return lambda x: deepsets(x, q, rho, agg=self.agg)
            return lambda x: deepsets_ref(x, q, rho, agg=self.agg)
        if self.mode == "fused":
            layer = cascade_mlp
        elif self.mode == "unfused":
            layer = mlp_unfused
        else:
            layer = cascade_mlp_ref

        def fn(x: torch.Tensor) -> torch.Tensor:
            b, m, f = x.shape
            return layer(x.reshape(b * m, f), q).reshape(b, m, -1)
        return fn

    # -- public API ------------------------------------------------------------
    def submit(self, x: np.ndarray) -> _Request:
        req = _Request(x=x, t_submit=time.perf_counter())
        self._q.put(req)
        return req

    def infer(self, x: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        req = self.submit(x)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise RuntimeError("serving batch failed") from req.error
        return req.result

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- batching loop ----------------------------------------------------------
    def _collect(self) -> List[_Request]:
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        first.t_dequeued = time.perf_counter()
        batch = [first]
        deadline = first.t_dequeued + self.window_us * 1e-6
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            req.t_dequeued = time.perf_counter()
            batch.append(req)
        return batch

    def _run(self, batch: List[_Request]) -> np.ndarray:
        xs = torch.from_numpy(np.stack([r.x for r in batch])).to(self.device)
        # .cpu() waits for the launch on this thread's current stream.
        return self._fn(xs).cpu().numpy()

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            t_start = time.perf_counter()
            for r in batch:
                r.t_start = t_start
            try:
                out = self._run(batch)
            except Exception as exc:  # the worker must outlive a bad batch
                for r in batch:
                    r.error = exc
                    r.event.set()
                continue
            t_done = time.perf_counter()
            for i, r in enumerate(batch):
                r.result = out[i]
                r.t_done = t_done
                self.stats.record(r.t_submit, t_done)
                r.event.set()
            self.stats.batch_sizes.append(len(batch))


__all__ = ["JetServer", "ServeStats", "MODES"]
