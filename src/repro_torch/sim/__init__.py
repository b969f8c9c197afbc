"""repro_torch.sim — discrete-event simulator of the AIE array (Tier-S).

Fidelity tiers of this repo:

  * **Tier-A** (:mod:`repro_torch.core.perfmodel`): the paper's closed-form
    Eq. (1)-(6) latency model, calibrated to Table 2 / Table 4. Congestion
    free by construction — it scores one instance in isolation. Two
    throughput readings per design: the serial ``1 / latency`` rate, and
    the pipelined ``1 / II`` rate where II =
    :func:`repro_torch.core.perfmodel.initiation_interval_cycles` is the
    bottleneck stage of the per-instance schedule (shim ingest+egress,
    per-layer bottleneck-tile occupancy, inter-layer edges). II <= latency
    always; the gap is the throughput a serial execution model leaves on
    the table.
  * **Tier-S** (this package): a discrete-event simulation that *executes*
    a placed design event by event on a resource model of the 8 x 38 array
    — per-tile compute occupancy from the Tier-A per-layer cycle model
    (:func:`repro_torch.core.perfmodel.layer_occupancy`), 512-bit/cycle cascade
    FIFO edges, 32-bit/cycle DMA hops with Manhattan routing, and
    shim-column PLIO ports that serialize when co-resident tenants share a
    column. For a single tenant it reproduces the analytic end-to-end
    latency; for multi-tenant schedules it prices the ingest contention the
    analytic model ignores.

**pipeline_depth semantics** (:class:`repro_torch.sim.run.SimConfig`): the
maximum number of in-flight events per instance. Depth 1 (default) is the
strictly serial execution model — event ``e+1`` is admitted only when
event ``e`` has fully egressed, reproducing the pre-pipelining Tier-S
numbers bit for bit. Depth ``d > 1`` admits event ``e+1`` once event
``e-d+1`` completes, so consecutive events overlap on the FIFO resources
(next ingest during current compute); single-tenant steady-state
throughput (:meth:`repro_torch.sim.run.SimResult.steady_throughput_eps`, fill
and drain transients trimmed) converges to ``1 / II``, and shim sharing
between tenants throttles the sustained interval rather than only the
latency. Arrival and completion order per instance are preserved at any
depth; a depth that at least covers ``ceil(latency / II) + 1`` keeps the
bottleneck stage saturated.

**Engine selection** (the ``engine=`` keyword on
:func:`repro_torch.sim.run.simulate_placement` /
:func:`repro_torch.sim.run.simulate_schedule` /
:func:`repro_torch.sim.run.sweep_latency_cycles`): Tier-S has two executions of
the same semantics.

  * ``engine="des"`` (default) — the full event loop over
    :class:`~repro_torch.sim.events.Task` objects. Keeps the task graph,
    per-resource spans, blame annotations, and (optionally) a Chrome
    trace; required by :func:`repro_torch.sim.run.invariant_errors`,
    :mod:`repro_torch.obs.profile`, and anything that inspects
    ``SimResult.graph``.
  * ``engine="fast"`` — :mod:`repro_torch.sim.fastpath` compiles the run once
    into struct-of-arrays templates and replays completion times with a
    static Lindley sweep (or an exact lean heap transcription when FIFO
    grant order is dynamic). **Bit-exact** with the DES on every
    completion/sojourn cycle — the parity suites compare with ``==`` —
    at an order-of-magnitude lower cost (>= 20x events/sec on the
    sweep-engine scenarios, gated by ``benchmarks/sim_fastpath.py``).
    Returns a :class:`~repro_torch.sim.fastpath.FastResult` (no task graph or
    spans); raises :class:`~repro_torch.sim.fastpath.FastpathUnsupported` when
    the config needs the DES (e.g. ``trace=True``).
  * ``engine="auto"`` — the fast path when supported, silent DES
    fallback otherwise (counted in ``sim.fastpath.fallbacks``). This is
    what the hot paths use: ``rescorer()`` / ``dse.search`` batch
    rescoring, ``core.calibrate`` sweeps, and the
    ``latency_under_load`` bench validation.

Entry points: :func:`repro_torch.sim.run.simulate_placement`,
:func:`repro_torch.sim.run.simulate_schedule`, :func:`repro_torch.sim.run.rescorer`
(the Tier-S hook for ``dse.search``).
"""
from .events import Resource, Simulator, Task, TaskGraph, DeadlockError
from .fastpath import (CompiledRun, FastResult, FastpathUnsupported,
                       Rescorer, compile_placement, compile_schedule, replay)
from .run import (SimConfig, SimResult, rescorer, simulate_placement,
                  simulate_schedule, sweep_latency_cycles)
from .trace import ChromeTrace

__all__ = [
    "ChromeTrace", "CompiledRun", "DeadlockError", "FastResult",
    "FastpathUnsupported", "Rescorer", "Resource", "SimConfig", "SimResult",
    "Simulator", "Task", "TaskGraph", "compile_placement",
    "compile_schedule", "replay", "rescorer", "simulate_placement",
    "simulate_schedule", "sweep_latency_cycles",
]
