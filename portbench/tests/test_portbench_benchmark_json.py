"""BENCHMARK.json keeps to its contract's shape, and every file a cell
needs is where the harness looks for it."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32


def test_names_and_units_use_the_allowed_characters():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in entry.get("reduced", []):
                assert NAME.match(key), key
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metric_names = [m["name"] for s in ("end_to_end", "per_layer")
                    for m in BENCH[s]]
    assert len(set(metric_names)) == len(metric_names)


def test_metrics_keep_their_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_readers(work):
    cell = harness.load_cell(work["name"], BENCH)
    assert cell.chips == 1
    harness.family(cell.config)
    assert cell.limits
    for m in cell.end_to_end:
        __import__(f"portbench.endtoend.{m['name']}")
    assert cell.per_layer
    for m in cell.per_layer:
        __import__(f"portbench.metrics.{m['name']}")
