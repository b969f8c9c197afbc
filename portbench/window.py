"""What every traffic loop shares: the window's counts, the seeded sample of
outputs kept for the check, and ``drive``, which runs the loop that the mix
names (``loops/<loop>.py``, found by ``spec.loop``).

A traffic mix's file (``traffic/<name>.json``) gives the loop's name and its
parameters, and these, which every loop reads:

* ``batch_events``: events a call; ``pool_batches``: distinct batches on the
  device, taken in turn, so that the pool, and not the L2, feeds each call;
* ``warmup_batches``, ``trace_seconds``, ``sample_batches``: the calls of
  set-up, the length of the traced stretch, the calls kept for the check.

Every loop issues its calls on a CUDA stream of its own, and counts a call
in ``done`` only where it completed inside the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class Window:
    seconds: float = 0.0            # host clock, first issue to the close
    issued: int = 0                 # calls issued
    done: int = 0                   # calls complete inside the window
    latencies_us: List[float] = dataclasses.field(default_factory=list)
    call_s: float = 0.0             # host time inside the port's calls


class Sample:
    """A reservoir of ``k`` calls' outputs, drawn from ``seed``: every call
    of the window is equally likely to be kept."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept = []              # (pool index, output)

    def offer(self, i: int, pool_index: int, out: torch.Tensor, *,
              copy: bool = False) -> None:
        """Keeps ``out`` (a copy of it with ``copy``, for a buffer that the
        next call overwrites) if the draw says so."""
        j = len(self.kept) if len(self.kept) < self.k else \
            self.rng.randrange(i + 1)
        if j < self.k:
            kept = (pool_index, out.clone() if copy else out)
            if j == len(self.kept):
                self.kept.append(kept)
            else:
                self.kept[j] = kept


_NO_LABEL = contextlib.nullcontext()


def no_label(name):
    return _NO_LABEL


def drive(fn: Callable, pool: List[torch.Tensor], traffic: dict, *,
          seconds: float = float("inf"), max_calls: Optional[int] = None,
          sample: Optional[Sample] = None, label=no_label) -> Window:
    """Runs the mix's loop until ``seconds`` have passed or ``max_calls``
    were issued; ``label(name)`` wraps the host's phases (the traced run
    passes ``record_function``)."""
    from portbench import spec
    loop = spec.loop(traffic["loop"])
    w = Window()
    stream = torch.cuda.Stream(pool[0].device)
    with torch.cuda.stream(stream):
        loop.drive(fn, pool, traffic, w, stream=stream, seconds=seconds,
                   limit=max_calls if max_calls is not None else float("inf"),
                   sample=sample, label=label)
    return w
