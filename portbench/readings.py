"""The readings that the correctness check's limits are set from.

    python3 -m portbench.readings --workload <cell> --seeds S1 S2 ...
                                  [--out FILE]

For each seed, in one process: the cell's pool of instances as a run
makes it, every distinct instance solved once through the timed entry
(the program, after one warm-up call), and every number of ``check.py``
worked out from those answers; then the control, the plain reference put
in the program's place and computed in float32 (the precision below the
configuration's float64), judged the same way. Beside them, two numbers
that no limit compares: ``obj_gap`` and ``y_err``, the answer's
objective and point against the float64 reference's (relative to
1 + |f*| and 1 + ‖y*‖∞). One JSON line per seed and side on standard
output (and appended to ``--out``); the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, harness, run
from .reference import certificate


def control_answers(cell, pool):
    """The control's answers, one per call slot: the family's reference
    in float32 in the program's place."""
    y, w, v, ok = check.reference_solutions(cell.config, pool, torch.float32)
    out = []
    for slot in range(pool.slots):
        rows = pool.rows(slot)
        status = ["Optimal" if s else "Unsolved" for s in ok[rows].tolist()]
        out.append((slot, harness.Answer(y[rows], w[rows], v[rows], status,
                                         [], [])))
    return out


def program_answers(program, cell, pool, device):
    call = harness.make_call(program, cell.traffic,
                             cell.config.get("options", {}), device)
    call(pool.operands(0))  # the cell's one shape: a miss
    return [(slot, call(pool.operands(slot))) for slot in range(pool.slots)]


def against_reference(pool, answers, ref) -> dict:
    """``obj_gap`` and ``y_err`` (module docstring), worst over
    ``answers``."""
    y_ref, w_ref, v_ref, _ = ref
    out = dict(obj_gap=0.0, y_err=0.0)
    for slot, ans in answers:
        rows = check.slot_rows(pool, slot)
        ops = pool.stack(rows)
        f = certificate.numbers(ops, ans.y, ans.w, ans.v)["obj"]
        f_ref = certificate.numbers(ops, y_ref[rows], w_ref[rows],
                                    v_ref[rows])["obj"]
        yr = y_ref[rows]
        check.worst(out, "obj_gap", (f - f_ref).abs() / (1 + f_ref.abs()))
        check.worst(out, "y_err",
                    (ans.y.to(torch.float64) - yr).abs().amax(-1)
                    / (1 + yr.abs().amax(-1)))
    return out


def readings(cell, seed, device):
    """{side: numbers} for the program and the control on ``seed``."""
    import conicip_tpu_torch as program

    pool = harness.Pool(cell.config, cell.traffic, seed, device)
    ref = check.reference_solutions(cell.config, pool, torch.float64)
    answers = program_answers(program, cell, pool, device)
    program.solver.graph.clear()
    got = {}
    for side, ans in (("program", answers),
                      ("control", control_answers(cell, pool))):
        got[side] = dict(check.numbers(pool, ans, ref[3]),
                         **against_reference(pool, ans, ref))
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.fix_cache_dirs()
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for side, values in readings(cell, seed, "cuda").items():
            line = json.dumps(dict(workload=cell.name, seed=seed, side=side,
                                   **values))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
