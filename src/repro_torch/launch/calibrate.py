"""Calibration driver: fit the overhead constants against a Tier-S sweep
and gate on the fit quality (fig9-style per-family R2/MAPE report).

Full sweep, print the report, write the JSON artifact CI archives:

    PYTHONPATH=src python -m repro_torch.launch.calibrate --report-out calib.json

CI-sized sweep with explicit gates (exit code 1 on violation):

    PYTHONPATH=src python -m repro_torch.launch.calibrate --smoke \\
        --gate-mape 0.10 --gate-r2 0.99

Per-stage drift localization — when the total drifts, name the stage and
the suspect constants (see ``repro_torch.core.calibrate.STAGE_SUSPECTS``):

    PYTHONPATH=src python -m repro_torch.launch.calibrate --families dma,agg
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import calibrate as cal


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", type=str, default=None,
                    help="comma-separated sweep families "
                         f"(default: all of {','.join(cal.FAMILIES)})")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized sweep (~1/3 of the grid, still full rank)")
    ap.add_argument("--events", type=int, default=1,
                    help="simulated events per sweep design")
    ap.add_argument("--report-out", type=str, default=None,
                    help="write the calibration report as JSON")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the calib.* metrics-registry snapshot as JSON")
    ap.add_argument("--gate-mape", type=float, default=0.10,
                    help="max per-family MAPE (fraction, default 0.10)")
    ap.add_argument("--gate-r2", type=float, default=0.99,
                    help="min overall R2 (default 0.99)")
    args = ap.parse_args()
    families = None
    if args.families:
        families = [s.strip() for s in args.families.split(",") if s.strip()]
        for f in families:
            if f not in cal.FAMILIES:
                ap.error(f"unknown family {f!r} (choose from "
                         f"{', '.join(cal.FAMILIES)})")
    if args.events < 1:
        ap.error("--events must be >= 1")

    report, reg, mon, stage_drift = cal.run_calibration(
        families, smoke=args.smoke, events=args.events)

    print(f"[calib] {report.n_points} sweep designs, "
          f"overall R2 {report.overall_r2:.6f}, "
          f"MAPE {report.overall_mape:.3e}")
    print(f"[calib] {'family':12s} {'n':>4s} {'R2':>10s} {'MAPE':>10s}")
    for fam in sorted(report.families):
        ff = report.families[fam]
        print(f"[calib] {fam:12s} {ff.n_points:4d} {ff.r2:10.6f} "
              f"{ff.mape:10.3e}")
    print(f"[calib] {'constant':15s} {'frozen':>10s} {'fitted':>10s} "
          f"{'rel err':>9s}")
    for name in cal.FIT_PARAMS:
        rec = report.params[name]
        print(f"[calib] {name:15s} {rec['frozen']:10.4f} "
              f"{rec['fitted']:10.4f} {rec['rel_err']:9.2e}")

    if stage_drift:
        print(f"[calib] per-stage drift: {stage_drift} stage(s) disagree "
              "with the simulator — suspects by stage kind:")
        for e in mon.localize(1e-6)[:10]:
            kind = e.metric.rsplit(".", 1)[-1]
            suspects = ", ".join(cal.STAGE_SUSPECTS.get(kind, ()))
            print(f"[calib]   {e.key}: modeled {e.modeled:.1f} vs measured "
                  f"{e.measured:.1f} ({100 * e.ape:.1f}%) -> {suspects}")
    else:
        print("[calib] per-stage drift: none (model == simulator on every "
              "pipeline stage)")

    if args.report_out:
        with open(args.report_out, "w") as f:
            json.dump(report.as_dict(), f, indent=2, sort_keys=True)
        print(f"[calib] report -> {args.report_out}")
    if args.metrics_out:
        reg.save(args.metrics_out,
                 extra={"driver": "calibrate", "smoke": args.smoke,
                        "families": families or list(cal.FAMILIES)})
        print(f"[calib] metrics: {len(reg.all())} series -> "
              f"{args.metrics_out}")

    errors = report.gate_errors(mape_max=args.gate_mape, r2_min=args.gate_r2)
    if errors:
        raise SystemExit("[calib] GATE FAILED:\n  " + "\n  ".join(errors))
    print(f"[calib] gate: PASS (per-family MAPE <= {args.gate_mape:.0%}, "
          f"overall R2 >= {args.gate_r2})")


if __name__ == "__main__":
    main()
