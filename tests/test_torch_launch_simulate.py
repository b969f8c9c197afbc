"""The port's ``launch.simulate`` and ``launch.calibrate`` against the JAX
package's: the CLI contract of tests/test_launch_simulate.py held against the
port (the same messages, warnings and exit codes), then both ``main()``s run
on the same argv, with stdout and every written JSON required equal (``==``).
"""
import json
import sys

import pytest

from repro.launch import calibrate as ref_calibrate
from repro.launch import simulate as ref_simulate
from repro.sim import fastpath as ref_fastpath
from repro_torch.launch import calibrate as port_calibrate
from repro_torch.launch import simulate as simulate_cli
from repro_torch.sim import fastpath as port_fastpath

DEPRECATED_STANDALONE = ("[sim] note: --jitter is deprecated; prefer "
                         "--arrivals (e.g. poisson:<eps>)")
DEPRECATED_IGNORED = ("[sim] note: --jitter is deprecated and ignored when "
                      "--arrivals is given")


def _run(monkeypatch, capsys, argv, cli=simulate_cli, prog="simulate"):
    monkeypatch.setattr(sys, "argv", [prog] + argv)
    cli.main()
    return capsys.readouterr().out


class TestJitterDeprecation:
    def test_standalone_jitter_warns_verbatim(self, monkeypatch, capsys,
                                              tmp_path):
        out = _run(monkeypatch, capsys,
                   ["--model", "jsc-m", "--events", "2", "--jitter", "32",
                    "--trace", str(tmp_path / "t.json")])
        assert DEPRECATED_STANDALONE in out
        assert DEPRECATED_IGNORED not in out

    def test_no_warning_without_jitter(self, monkeypatch, capsys, tmp_path):
        out = _run(monkeypatch, capsys,
                   ["--model", "jsc-m", "--events", "2",
                    "--trace", str(tmp_path / "t.json")])
        assert "--jitter is deprecated" not in out

    def test_jitter_with_arrivals_is_warned_and_ignored(self, monkeypatch,
                                                        capsys, tmp_path):
        base = ["--model", "jsc-m", "--events", "4", "--seed", "3",
                "--pipeline-depth", "2", "--arrivals", "poisson:1000000",
                "--trace", str(tmp_path / "t.json")]
        out_plain = _run(monkeypatch, capsys, base)
        out_jitter = _run(monkeypatch, capsys, base + ["--jitter", "64"])
        assert DEPRECATED_IGNORED in out_jitter
        assert DEPRECATED_IGNORED not in out_plain
        stripped = [ln for ln in out_jitter.splitlines()
                    if ln != DEPRECATED_IGNORED]
        assert stripped == out_plain.splitlines()

    def test_help_epilog_documents_removal_timeline(self, monkeypatch,
                                                    capsys):
        monkeypatch.setattr(sys, "argv", ["simulate", "--help"])
        with pytest.raises(SystemExit) as exc:
            simulate_cli.main()
        assert exc.value.code == 0
        out = capsys.readouterr().out
        assert "deprecations:" in out
        assert "--jitter" in out
        assert "releases after this deprecation" in out
        assert "poisson:<eps>" in out


class TestProfileFlags:
    def test_profile_artifacts_and_gate(self, monkeypatch, capsys, tmp_path):
        prof_path = tmp_path / "profile.json"
        flame_path = tmp_path / "flame.txt"
        out = _run(monkeypatch, capsys,
                   ["--model", "jsc-m", "--events", "2",
                    "--profile-out", str(prof_path),
                    "--flame-out", str(flame_path),
                    "--blame-gate", "0.05",
                    "--trace", str(tmp_path / "t.json")])
        assert "blame drift gate: PASS" in out
        prof = json.loads(prof_path.read_text())
        assert prof["blame_cycles"]
        assert prof["conservation_errors"] == []
        assert prof["blame_mape"] <= 0.05
        assert prof["top_levers"][0]["speedup"] >= 1.0
        assert flame_path.read_text().strip()
        trace = json.loads((tmp_path / "t.json").read_text())
        assert any(e["ph"] in ("s", "f") for e in trace["traceEvents"])

    def test_failing_gate_exits_nonzero(self, monkeypatch, capsys, tmp_path):
        monkeypatch.setattr(
            sys, "argv",
            ["simulate", "--model", "jsc-m", "--events", "2",
             "--blame-gate", "-1.0",
             "--trace", str(tmp_path / "t.json")])
        with pytest.raises(SystemExit) as exc:
            simulate_cli.main()
        assert "blame drift gate FAILED" in str(exc.value)


def _twin_runs(monkeypatch, capsys, tmp_path, argv, ref, port, prog):
    """Runs the reference's and the port's ``main()`` on ``argv``, each in a
    directory of its own so that the relative output paths (and so stdout)
    agree; returns (stdout, directory) for each.

    The fast path's replay and fallback counters (``sim.fastpath.COUNTERS``,
    exported into the metrics) count for the whole process, so a fast-path
    test that ran earlier in the same worker would raise one package's
    count and not the other's. Both are set to a fresh dict before each
    run, so that each run counts only its own replays."""
    runs = []
    for name, cli in (("ref", ref), ("port", port)):
        for fp in (ref_fastpath, port_fastpath):
            monkeypatch.setattr(fp, "COUNTERS", {"replays": {},
                                                 "fallbacks": {}})
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        runs.append((_run(monkeypatch, capsys, argv, cli, prog), d))
    return runs


# Gauges of the host's wall clock (how long the fast path took to compile and
# replay on this machine): the one thing two runs cannot share.
WALL_CLOCK = {"sim.fastpath.compile_s", "sim.fastpath.replay_s",
              "sim.fastpath.events_per_sec"}


def _json(path):
    d = json.loads(path.read_text())
    if isinstance(d, dict) and "gauges" in d:
        d["gauges"] = [g for g in d["gauges"] if g["name"] not in WALL_CLOCK]
    return d


def _same_files(a, b, names):
    for n in names:
        if n.endswith(".json"):
            assert _json(a / n) == _json(b / n), n
        else:
            assert (a / n).read_text() == (b / n).read_text(), n


PROFILE = ["--profile-out", "p.json", "--flame-out", "f.txt"]


@pytest.mark.parametrize("argv", [
    ["--model", "deepsets-32", "--events", "3"] + PROFILE,
    ["--model", "jsc-m", "--events", "4", "--seed", "3", "--pipeline-depth",
     "2", "--arrivals", "poisson:1000000", "--jitter", "64"] + PROFILE,
    ["--model", "deepsets-32", "--replicas", "3", "--events", "2",
     "--engine", "fast"],
    ["--mix", "deepsets-32,jsc-m", "--events", "2", "--tier-s"] + PROFILE,
], ids=["single", "open-loop", "replicas-fast", "mix"])
def test_simulate_main_equals_the_reference(monkeypatch, capsys, tmp_path,
                                            argv):
    files = ["t.json", "m.json", "p.json", "f.txt"]
    argv = argv + ["--trace", "t.json", "--metrics-out", "m.json"]
    (out_ref, d_ref), (out_port, d_port) = _twin_runs(
        monkeypatch, capsys, tmp_path, argv, ref_simulate, simulate_cli,
        "simulate")
    assert out_port == out_ref
    written = [f for f in files if (d_ref / f).exists()]
    assert written == [f for f in files if (d_port / f).exists()]
    assert "m.json" in written
    _same_files(d_ref, d_port, written)


def test_twin_runs_ignore_an_earlier_reference_replay(monkeypatch, capsys,
                                                      tmp_path):
    """A reference fast-path replay earlier in the same process (as another
    test file may run first in the same worker) raises the reference's
    process-wide replay count; the replicas-fast twin run that follows is
    still equal, gauges and all."""
    argv = ["--model", "deepsets-32", "--replicas", "3", "--events", "2",
            "--engine", "fast", "--trace", "t.json", "--metrics-out",
            "m.json"]
    before = tmp_path / "before"
    before.mkdir()
    monkeypatch.chdir(before)
    _run(monkeypatch, capsys, argv, ref_simulate)
    assert sum(ref_fastpath.COUNTERS["replays"].values()) > 0
    twin = tmp_path / "twin"
    twin.mkdir()
    (out_ref, d_ref), (out_port, d_port) = _twin_runs(
        monkeypatch, capsys, twin, argv, ref_simulate, simulate_cli,
        "simulate")
    assert out_port == out_ref
    _same_files(d_ref, d_port, ["m.json"])
    assert "sim.fastpath" in (d_port / "m.json").read_text()


def test_simulate_gate_failure_equals_the_reference(monkeypatch, tmp_path):
    argv = ["simulate", "--model", "jsc-m", "--events", "2",
            "--blame-gate", "-1.0", "--trace", str(tmp_path / "t.json")]
    monkeypatch.setattr(sys, "argv", argv)
    msgs = []
    for cli in (ref_simulate, simulate_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("argv", [
    ["--smoke", "--families", "dma,agg"],
    ["--smoke", "--events", "2"],
], ids=["two-families", "all-families"])
def test_calibrate_main_equals_the_reference(monkeypatch, capsys, tmp_path,
                                             argv):
    argv = argv + ["--report-out", "r.json", "--metrics-out", "m.json"]
    (out_ref, d_ref), (out_port, d_port) = _twin_runs(
        monkeypatch, capsys, tmp_path, argv, ref_calibrate, port_calibrate,
        "calibrate")
    assert out_port == out_ref
    assert "[calib] gate: PASS" in out_port
    _same_files(d_ref, d_port, ["r.json", "m.json"])


@pytest.mark.parametrize("argv", [
    ["--smoke", "--families", "dma", "--gate-r2", "1.5"],
    ["--families", "nope"],
], ids=["gate", "unknown-family"])
def test_calibrate_failures_equal_the_reference(monkeypatch, capsys, argv):
    results = []
    for cli in (ref_calibrate, port_calibrate):
        monkeypatch.setattr(sys, "argv", ["calibrate"] + argv)
        with pytest.raises(SystemExit) as exc:
            cli.main()
        cap = capsys.readouterr()
        results.append((str(exc.value), cap.out, cap.err))
    assert results[0] == results[1]
