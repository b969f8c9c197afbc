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
an MLP takes the (B*M, F) rows. On CUDA each server launches on a stream of
its own, so that the replicas of a fleet do not serialize on one stream.
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
from repro_torch.core import h100_model
from repro_torch.core.h100_model import LayerShape
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
    ``device`` defaults to CUDA and raises where there is none. On CUDA the
    worker thread runs every batch on ``stream``, a ``torch.cuda.Stream`` of
    this server's own (None on the CPU), and ``launch_streams`` holds the
    handle of each stream a batch ran on.
    ``on_done``, if given, is called once per served request, after its
    result is set and before its waiter wakes; an exception it raises is
    swallowed, so that an observer never stops the worker.
    """

    def __init__(self, qmlp: QuantizedMLP, *,
                 rho: Optional[QuantizedMLP] = None,
                 agg: str = "mean",
                 mode: str = "fused",
                 max_batch: int = 64,
                 window_us: float = 200.0,
                 device="cuda",
                 on_done: Optional[Callable[[_Request], None]] = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.device = resolve_device(device)
        if rho is not None and mode == "unfused" and self.device.type == "cuda":
            raise ValueError("DeepSets has no per-layer kernel path: mode "
                             "'unfused' would serve its plain version on CUDA")
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.launch_streams: set = set()
        self.qmlp = qmlp.to(self.device)
        self.rho = None if rho is None else rho.to(self.device)
        self.agg = agg
        self.mode = mode
        self.max_batch = max_batch
        self.window_us = window_us
        self.on_done = on_done
        self.stats = ServeStats()
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._fn = self._build()
        if self.stream is not None:
            # The weights and the packed-weight cache were made on this
            # thread's stream: the worker's first launch must come after.
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            self._prime_stream()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _prime_stream(self) -> None:
        """Gives this server's stream device memory of its own before the
        first request. The caching allocator keeps freed blocks per stream,
        so the first batch on a fresh stream would otherwise call cudaMalloc,
        which CUDA serializes across threads, inside its requests'
        latency. One byte goes to the device and back on the stream, which
        leaves it a cached small-pool segment (2 MB, for blocks up to 1 MB:
        a served batch of the models here, in and out). No kernel runs."""
        with torch.cuda.stream(self.stream):
            torch.zeros(1, dtype=torch.int8).to(self.device).cpu()

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
        # Allocated inside the worker's stream context, so the caching
        # allocator ties xs to this server's stream.
        xs = torch.from_numpy(np.stack([r.x for r in batch])).to(self.device)
        out = self._fn(xs)
        if self.stream is not None:
            self.launch_streams.add(
                torch.cuda.current_stream(self.device).cuda_stream)
        # .cpu() waits for the launch on this thread's current stream.
        return out.cpu().numpy()

    def _loop(self):
        # torch.cuda.stream(None), on the CPU, is a no-op context.
        with torch.cuda.stream(self.stream):
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
                    if self.on_done is not None:
                        # A raising observer must not strand the waiters.
                        try:
                            self.on_done(r)
                        except Exception:
                            pass
                    r.event.set()
                self.stats.batch_sizes.append(len(batch))

    # -- Tier-B modeled latency on the H100 ---------------------------------------
    def modeled_latency_us(self) -> dict:
        """The chain's device time on the H100 by :mod:`h100_model`, fused
        (one K2 or K3 launch) against per-layer (one K1 launch a layer), for
        the JAX server's layer shapes: M = 64 rows for an MLP, and for
        DeepSets M = phi's input width (not the set size) for every layer."""
        ds = self.rho is not None
        m = self.qmlp.layers[0].w_q.shape[0] if ds else 64
        chain = list(self.qmlp.layers) + (list(self.rho.layers) if ds else [])
        layers = [LayerShape(M=m, K=l.w_q.shape[0], N=l.w_q.shape[1],
                             bias=l.bias_q is not None) for l in chain]
        kernel = "deepsets" if ds else "cascade_mlp"
        fused = h100_model.fused_chain_time_s(layers, kernel=kernel) * 1e6
        unfused = h100_model.unfused_chain_time_s(layers) * 1e6
        return {"fused_us": fused, "unfused_us": unfused,
                "speedup": unfused / fused}


__all__ = ["JetServer", "ServeStats", "MODES"]
