"""The benchmark's definition, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells and metrics. Each has files of its own under ``portbench/``:

* a configuration ``<name>``: ``configs/<name>.json`` (its sizes), run by
  ``reference/<kind>.py`` (its plain reference, operations and bytes) and
  ``port/<kind>.py`` (how the port is called), ``kind`` named in the file;
  the file may state how its outputs are compared (``"compare"``, see
  ``compare.py``) and the precision whose peak its shares divide by
  (``"peak"``, see ``roofline.py``);
* a traffic mix ``<name>``: ``traffic/<name>.json``, parameters read by the
  loop it names, ``loops/<loop>.py`` (``window.py`` lists what every loop
  reads);
* a metric ``<name>``: ``metrics/<name>.py``, whose ``read(run)`` returns the
  number or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

from portbench import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _data(folder: str, name: str) -> dict:
    with open(HERE / folder / f"{check_name(name)}.json") as f:
        return json.load(f)


def check_config(cfg: dict) -> dict:
    """``cfg``, or ValueError where its ``"compare"`` block is malformed."""
    if "compare" in cfg:
        compare.check_rule(cfg["compare"])
    return cfg


def config(name: str) -> dict:
    return check_config(_data("configs", name))


def traffic(name: str) -> dict:
    return _data("traffic", name)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def reference(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{check_name(kind)}")


def port(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.port.{check_name(kind)}")


def loop(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.loops.{check_name(name)}")


def reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by its path (a name may hold dots)."""
    path = HERE / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listed(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _listed(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """Per-layer metrics the cell reports: those that list it, and those
    that list no cells where the cell reports the metric they move."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]
