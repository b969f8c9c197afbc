"""Fault-tolerance runtime: step watchdog and straggler detection, a copy of
the JAX package's ``src/repro/distributed/ft.py`` (numpy and threads).

  1. **Checkpoint/restart**: ``repro_torch.ckpt``, atomic committed
     checkpoints, auto-resume from the newest COMMIT, async off the step
     loop.
  2. **Failure detection**: this module, a wall-clock watchdog around the
     step loop. A dead peer shows as a hung collective, so the watchdog's
     only safe action is process exit: the cluster manager restarts the
     job, which auto-resumes. The timeout is a grace multiple of the
     trailing median step time.
  3. **Straggler mitigation**: a ring buffer of step times; a step slower
     than ``straggler_factor`` x the median counts as a straggler.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class WatchdogConfig:
    grace_factor: float = 10.0      #: hang threshold: factor x median step
    straggler_factor: float = 2.0   #: straggler threshold
    min_timeout_s: float = 60.0     #: floor before medians stabilize
    window: int = 64                #: trailing steps for the median


class StepWatchdog:
    """Detects hung or straggling steps from wall-clock timing.

    Usage::

        wd = StepWatchdog(on_hang=lambda: os._exit(42))
        for batch in stream:
            with wd.step():
                run_step(batch)
    """

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(),
                 on_hang: Optional[Callable[[], None]] = None):
        self.cfg = cfg
        self.times: List[float] = []
        self.stragglers = 0
        self._on_hang = on_hang or (lambda: os.kill(os.getpid(),
                                                    signal.SIGTERM))
        self._timer: Optional[threading.Timer] = None

    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0

    def timeout_s(self) -> float:
        med = self.median()
        return max(self.cfg.min_timeout_s, self.cfg.grace_factor * med)

    class _StepCtx:
        def __init__(self, wd: "StepWatchdog"):
            self.wd = wd

        def __enter__(self):
            wd = self.wd
            wd._timer = threading.Timer(wd.timeout_s(), wd._on_hang)
            wd._timer.daemon = True
            wd._timer.start()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            wd = self.wd
            dt = time.perf_counter() - self.t0
            if wd._timer is not None:
                wd._timer.cancel()
            med = wd.median()
            if med and dt > wd.cfg.straggler_factor * med:
                wd.stragglers += 1
            wd.times.append(dt)
            del wd.times[:-wd.cfg.window]
            return False

    def step(self) -> "_StepCtx":
        return self._StepCtx(self)
