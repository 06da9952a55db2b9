"""On the card: each cell runs end to end, a short window, and comes out
correct with every metric it names. Skips where there is no card (the
test decides that itself); run on the card with
``python -m pytest portbench/tests -m cuda -q``."""

import json

import pytest
import torch

from portbench import harness, run

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(name, trace):
    card()
    run.fix_cache_dirs()
    cell = harness.load_cell(name)
    out = run.measure(cell, 2**31 + 17, 1.0, trace)
    assert out["correct"], out["check"]
    specs = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) == {m["name"] for m in specs}
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
