"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric loads by name, the names and units keep to their characters, and
no module of the benchmark imports JAX or the JAX package."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import spec

BENCH = spec.benchmark()
HERE = Path(spec.__file__).resolve().parent


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_load_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = spec.config(c["name"])
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    ref = spec.reference(cfg["kind"])
    assert ref.ops_per_event(cfg) > 0
    spec.port(cfg["kind"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    t = spec.traffic(w["traffic"])
    assert t["name"] == w["traffic"]
    assert callable(spec.loop(t["loop"]).drive)
    e2e = {m["name"] for m in spec.end_to_end(BENCH, w["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(BENCH, w["name"])


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("m", _metrics(), ids=lambda m: m["name"])
def test_metrics_load_by_name(m):
    assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.reader(m["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_cells_report_what_it_moves(m):
    assert "bound" not in m and m["layer"] and "\n" not in m["layer"]
    for cell in m["workloads"]:
        moved = {e["name"] for e in spec.end_to_end(BENCH, cell)}
        assert m["moves"] in moved, (m["name"], cell)


def test_names_and_lines():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in _metrics()]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    for n in names:
        assert spec.NAME.match(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")


def _imports(path: Path):
    """Top-level names of the absolute imports in one source file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, found


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))
