"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up makes the cell's int8 model and its pool of event batches on
the device from ``--seed``, builds the port's kernels where this checkout
has not yet (``build/repro_torch/``), and warms up the cell's own shapes.
The window then drives the port's batched forward for ``--seconds`` under
the cell's traffic (``loops/<loop>.py``). With ``--trace 1`` a further stretch of
the same traffic runs under ``torch.profiler`` and the per-layer metrics
are reported instead of the end-to-end ones. Last, a sample of the window's
outputs, drawn from the seed, is compared with the plain reference
(``reference/``), TF32 off for the reference alone: ``correct`` holds where
every score is equal, or, for a configuration that states a ``"compare"``
rule, within its tolerance (``compare.py``).

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error. Exits non-zero, printing no result,
where there is no CUDA device, or fewer than the cell asks for, and where
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # The checkout, not this folder, heads the path: ``portbench`` is a
    # package there, and the port's package is under src/.
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    # One process drives the card; its host work needs no thread pool.
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from collections import defaultdict  # noqa: E402
from types import ModuleType  # noqa: E402
from typing import Callable, Optional  # noqa: E402

import torch  # noqa: E402

from portbench import compare, devtrace, roofline, spec, window  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (its start as the kernel records
    it, so the interpreter's own start-up counts)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    ref: ModuleType                 # reference/<kind>.py
    batch_events: int
    peak: tuple                     # (ops/s at the config's precision,
                                    #  bytes/s) of the card
    setup_s: float = 0.0
    window: window.Window = None
    launches: Optional[int] = None  # the port's launches in the window
    trace: Optional[dict] = None    # devtrace.reduce of the traced window


def _launch_total() -> int:
    from repro_torch.kernels import launches
    return sum(launches.snapshot().values())


def _sampled_pairs(ref, cfg, model, pool, sample: window.Sample):
    """(output, the reference's) for each sampled call; the reference runs
    once for each pool batch sampled."""
    by_batch = defaultdict(list)
    for p, out in sample.kept:
        by_batch[p].append(out)
    for p, outs in sorted(by_batch.items()):
        want = ref.forward(cfg, model, pool[p])
        for out in outs:
            yield out, want


def check(ref, cfg, model, pool, sample: window.Sample) -> dict:
    """The checks over the sampled calls (``compare.checks``, by the
    configuration's ``"compare"`` rule, exact without one), the reference
    computed with TF32 off."""
    with compare.no_tf32():
        return compare.checks(_sampled_pairs(ref, cfg, model, pool, sample),
                              cfg.get("compare"))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             forward: Optional[Callable] = None,
             wrap: Optional[Callable] = None) -> dict:
    """One run of one cell on the first CUDA device; returns the result line
    as a dict.

    ``forward(cfg, model)``, where given, builds what the window drives in
    the port's place (the lower-precision control); ``wrap(fn)`` wraps the
    port's forward (the fault tests). The command passes neither.
    """
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    ref = spec.reference(cfg["kind"])
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(dev)
    run = Run(config=cfg, traffic=traffic, ref=ref,
              batch_events=traffic["batch_events"],
              peak=roofline.peaks(name, cfg.get("peak", "int8")))

    # Set-up: the model and the pool, the port, a warm-up of the cell's
    # shapes.
    marks = [("imports", process_age_s())]
    model, pool = ref.make_inputs(cfg, traffic, seed, dev)
    torch.cuda.synchronize(dev)
    marks.append(("model and pool", process_age_s()))
    fn = (forward(cfg, model) if forward is not None
          else spec.port(cfg["kind"]).build(cfg, model))
    if wrap is not None:
        fn = wrap(fn)
    marks.append(("port", process_age_s()))
    window.drive(fn, pool, traffic, max_calls=traffic["warmup_batches"])
    torch.cuda.synchronize(dev)
    marks.append(("warm-up", process_age_s()))
    print("set-up at (s): " + ", ".join(f"{k} {v:.3f}" for k, v in marks),
          file=sys.stderr)
    gc.collect()
    gc.freeze()
    run.setup_s = process_age_s()

    # The window.
    counted = forward is None
    n0 = _launch_total() if counted else 0
    sample = window.Sample(traffic["sample_batches"], seed)
    run.window = window.drive(fn, pool, traffic, seconds=seconds,
                              sample=sample)
    torch.cuda.synchronize(dev)
    if counted:
        run.launches = _launch_total() - n0
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    if trace:
        def traced_stretch(label):
            window.drive(fn, pool, traffic, seconds=traffic["trace_seconds"],
                         label=label)
            torch.cuda.synchronize(dev)
        run.trace = devtrace.traced(traced_stretch)

    # The check, with the program's state freed.
    del fn
    gc.unfreeze()
    gc.collect()
    checks = check(ref, cfg, model, pool, sample)

    metrics = (spec.per_layer(bench, cell_name) if trace
               else spec.end_to_end(bench, cell_name))
    values = {}
    for m in metrics:
        v = spec.reader(m["name"]).read(run)
        if v is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": compare.correct(checks),
        "attempted": run.window.issued * run.batch_events,
        "failed": 0,
        "metrics": values,
        "device": {"platform": "gpu", "kind": name,
                   "count": cell["chips"], "memory_peak_bytes": peak_bytes},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["card"] = card_line()
    result["checks"] = checks
    return result


def banned_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    chips = spec.cell(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = banned_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} ({c['holds_if']}, limit "
              f"{c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
