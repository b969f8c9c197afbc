"""A trigger's client: one call at a time, each call's decision copied into
page-locked host memory before the next call is issued.

The copy is queued behind the call and the host spins on an event queued
behind the copy, so the host's wake-up from a blocking wait falls in no
call's time. A call's latency, from handing the batch to the port until
its scores are in host memory, is read from two CUDA events on the loop's
otherwise idle stream: the device's clock, since the host's is too coarse
for one call. No traffic key of its own.
"""
from __future__ import annotations

import time

import torch


def drive(fn, pool, traffic, w, *, stream, seconds, limit, sample, label):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n_pool = len(pool)
    host = None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    i = 0
    while i < limit and time.perf_counter() < t_end:
        p = i % n_pool
        start.record(stream)
        with label("portbench.call"):
            tc = time.perf_counter()
            out = fn(pool[p])
            w.call_s += time.perf_counter() - tc
        with label("portbench.copy_out"):
            if host is None:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            host.copy_(out, non_blocking=True)
            end.record(stream)
        with label("portbench.wait"):
            while not end.query():
                pass
        w.latencies_us.append(start.elapsed_time(end) * 1e3)
        w.done += 1
        if sample is not None:
            sample.offer(i, p, host, copy=True)
        i += 1
    w.seconds = time.perf_counter() - t0
    w.issued = i
