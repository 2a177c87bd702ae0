"""Finding a cell's parts by name: `BENCHMARK.json`'s entries, a
configuration (`configs/<name>.json` and its scene builder
`configs/<name>.py`), a traffic mix (`traffic/<name>.json`), the limits of a
cell's check (`checks/<cell>.json`) and a metric's reader
(`metrics/<name>.py`, or `metrics/<quantity>.py` for a metric `<quantity>.<part>`
that has none of its own: one quantity split by the end-to-end metric it
moves). A later cell, configuration, mix or metric is added
by adding files and entries: nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

PACKAGE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(checkout: str) -> dict:
    return read_json(os.path.join(checkout, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that this cell reports: those
    that list it under `workloads`, and those that list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def config(name: str, root: str = PACKAGE) -> dict:
    return read_json(os.path.join(root, "configs", _name(name) + ".json"))


def traffic(name: str, root: str = PACKAGE) -> dict:
    return read_json(os.path.join(root, "traffic", _name(name) + ".json"))


def checks(cell: str, root: str = PACKAGE) -> dict:
    return read_json(os.path.join(root, "checks", _name(cell) + ".json"))


def _module(path: str):
    key = "portbench_file_" + re.sub(r"\W", "_", os.path.relpath(path, os.path.dirname(PACKAGE)))
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return mod


def builder(name: str, root: str = PACKAGE):
    """The scene builder of a configuration: its `build(cfg) -> SceneSpec`."""
    return _module(os.path.join(root, "configs", _name(name) + ".py")).build


def reader(name: str, root: str = PACKAGE):
    """A metric's reader: its `read(ctx) -> float | None`."""
    path = os.path.join(root, "metrics", _name(name) + ".py")
    if not os.path.exists(path):
        path = os.path.join(root, "metrics", name.split(".")[0] + ".py")
    return _module(path).read
