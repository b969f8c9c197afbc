"""Reads the comparison's numbers at a cell's own size on many seeds, in one
process: the program's, and its control's, which the comparison has to
reject: the plain reference in the program's place, computed in the
nearest precision below the configuration's. That is the reference's own
``lower_precision(cfg, model)`` where its kind defines one (a float kind),
and the 4-bit grid (``reference.int8``, ``bits=4``) otherwise. The
benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seconds 2 \
        --seeds 11 12 ... --control-seeds 21 22 23

Prints one JSON line a run: the seed, which side, ``correct`` and each
number compared.
"""
from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import run, spec  # noqa: E402


def lower_precision(cfg, model):
    """The reference in the lower precision, as the window drives the
    program: its kind's own ``lower_precision``, or at 4 bits."""
    ref = spec.reference(cfg["kind"])
    if hasattr(ref, "lower_precision"):
        return ref.lower_precision(cfg, model)
    return lambda x: ref.forward(cfg, model, x, bits=4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    runs = ([(s, "program", None) for s in args.seeds]
            + [(s, "control", lower_precision) for s in args.control_seeds])
    for seed, side, forward in runs:
        r = run.run_cell(args.workload, seed, args.seconds, False,
                         forward=forward)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
