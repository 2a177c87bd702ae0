"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and entries, and the files each entry names."""

import json
import os
import re

import pytest

from portbench import registry

BENCH = registry.benchmark(os.path.dirname(registry.PACKAGE))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        assert registry.config(c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(os.path.dirname(registry.PACKAGE), c["file"]))
        assert callable(registry.builder(c["name"]))
    for w in BENCH["workloads"]:
        assert registry.traffic(w["traffic"])["entry"] in ("render", "iterative_render")
        assert set(registry.checks(w["name"])["limits"]) >= {"image_off", "image_gap"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one(cell):
    e2e = [m["name"] for m in registry.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = registry.metrics_of(BENCH, cell, "per_layer")
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
