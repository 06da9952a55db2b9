"""The correctness check, driven through the rest of a run on the CPU at
a small size (the harness's look for a card skipped): sound runs come out
correct; the control (the plain reference in float32 in the program's
place) and each fault a cell can have, planted under the timed path, come
out not correct. Faults that no cell here can have: the exchange between
chips left out (every cell takes one chip)."""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

import conicip_tpu_torch as program
from conicip_tpu_torch.parallel.batch import BatchSolution
from conicip_tpu_torch.solver import ipm
from conicip_tpu_torch.solver.state import Vec4
from portbench import harness, run

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
STACKS = [name for name in CELLS
          if harness.load_cell(name).traffic["entry"] == "solve_batch"]
SEED = 2**31 + 2**20 + 3
SECONDS = 0.3


def small(name):
    """The cell at a size a test run holds: the same files, smaller sizes
    and pool."""
    cell = harness.load_cell(name)
    config = dict(cell.config, **harness.family(cell.config).TEST_SIZE)
    traffic = dict(cell.traffic)
    traffic["pool"] = 3
    traffic["batch"] = min(traffic["batch"], 4)
    return dataclasses.replace(cell, config=config, traffic=traffic)


def measure(cell):
    torch.set_num_threads(1)
    return run.measure(cell, SEED, SECONDS, 0, device="cpu")


def compared(out):
    return {name: value for name, value, _ in out["check"]}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = measure(small(name))
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"solves_per_s", "call_ms_p95", "setup_s"}


def reference_in_place(cell, monkeypatch):
    """The control: the family's plain reference in float32 answers every
    call in the program's place."""
    fam = harness.family(cell.config)

    def solve(kw, single):
        ops = {k: x[None] if single else x for k, x in kw.items()
               if isinstance(x, torch.Tensor)}
        ops["cone_dims"] = kw["cone_dims"]
        y, w, v, ok = fam.reference(ops, torch.float32)
        status = ["Optimal" if s else "Abandoned" for s in ok.tolist()]
        return y.double(), w.double(), v.double(), status

    def conic_ip(**ops):
        y, w, v, status = solve(ops, True)
        return SimpleNamespace(y=y[0], w=w[0], v=v[0], status=status[0],
                               Iter=0)

    def solve_batch(**ops):
        y, w, v, status = solve(ops, False)
        return SimpleNamespace(y=y, w=w, v=v, statuses=status,
                               Iter=torch.zeros(len(status)))

    monkeypatch.setattr(program, "conic_ip", conic_ip)
    monkeypatch.setattr(program, "solve_batch", solve_batch)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, monkeypatch):
    cell = small(name)
    reference_in_place(cell, monkeypatch)
    out = measure(cell)
    assert not out["correct"]
    # the precision is what fails: the f32 answers are certified optimal
    assert compared(out)["dual_res"] > cell.limits["dual_res"]


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged(name, monkeypatch):
    real = ipm._select

    def stuck(mask, new, old):
        return old if isinstance(new, Vec4) else real(mask, new, old)

    monkeypatch.setattr(ipm, "_select", stuck)
    out = measure(small(name))
    assert not out["correct"]
    assert compared(out)["status_mismatch"] > 0


@pytest.mark.parametrize("name", STACKS)
def test_half_of_the_stack_left_out(name, monkeypatch):
    """The stack's second half is never solved: it gets the first half's
    answers."""
    real = program.solve_batch

    def half(**ops):
        h = ops["c"].shape[0] // 2
        sol = real(**{k: x[:h] if isinstance(x, torch.Tensor) else x
                      for k, x in ops.items()})
        return BatchSolution(**{f.name: torch.cat([getattr(sol, f.name)] * 2)
                                for f in dataclasses.fields(sol)})

    monkeypatch.setattr(program, "solve_batch", half)
    out = measure(small(name))
    assert not out["correct"]
    assert compared(out)["dual_res"] > 1e-6


@pytest.mark.parametrize("name", CELLS)
def test_one_answer_altered_where_it_is_produced(name, monkeypatch):
    """One entry of one instance's y, in the window's first call, moved
    by 1e-6."""
    cell = small(name)
    calls = {"n": 0}
    first_in_window = min(3, cell.traffic["pool"])
    for entry in ("conic_ip", "solve_batch"):
        real = getattr(program, entry)

        def altered(*args, _real=real, **kw):
            sol = _real(*args, **kw)
            if calls["n"] == first_in_window:
                sol.y.view(-1)[0] += 1e-6
            calls["n"] += 1
            return sol

        monkeypatch.setattr(program, entry, altered)
    out = measure(cell)
    assert not out["correct"]
    assert compared(out)["dual_res"] > cell.limits["dual_res"]
