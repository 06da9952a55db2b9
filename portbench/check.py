"""Whether what the timed window returned is correct.

Every answer of the window is judged, once the window has closed and the
program's state is freed, against the plain reference
(``portbench/reference/``), which reads the program's outputs only to
judge them:

- ``status_mismatch``: instances whose status is not the reference's.
  The reference solves each distinct instance of the pool in float64;
  where it converges the instance has an optimum, so the right status is
  ``Optimal``.
- ``dual_res``: the largest stationarity residual
  ‖Qy − c − Aᵀv + Gᵀw‖₂/(1 + ‖c‖₂) of any answer, worked out in float64 from
  the instance's data (:mod:`.reference.certificate`).
- ``cert``: the largest of any answer's primal and dual cone violation and
  complementarity, the measures that the solver's stopping rule holds
  under ``optTol``.

``limits/<workload>.json`` names the numbers that decide ``correct`` and
the limit of each.
"""

from __future__ import annotations

import math

import torch

from .harness import family
from .reference import certificate

# instances the reference solves in one batch
REFERENCE_BLOCK = 64


def reference_solutions(config, pool, dtype):
    """The family's plain reference (or, in float32, its control) on every
    distinct instance of the pool: (y, w, v, solved), one row each."""
    fam = family(config)
    count = pool.batch * pool.slots
    parts = []
    for lo in range(0, count, REFERENCE_BLOCK):
        part = fam.reference(
            pool.stack(slice(lo, min(lo + REFERENCE_BLOCK, count))), dtype)
        parts.append([x.to(torch.float64) for x in part[:3]] + [part[3]])
    return tuple(torch.cat(xs) for xs in zip(*parts))


def slot_rows(pool, slot) -> slice:
    return pool.rows(slot) if pool.stacked else slice(slot, slot + 1)


def worst(out: dict, name: str, per_instance) -> None:
    """``out[name]``, raised to the largest of ``per_instance``; NaN is
    worse than any number, and max() keeps a NaN it holds."""
    value = per_instance.max().item()
    out[name] = value if math.isnan(value) else max(out[name], value)


def numbers(pool, answers, solved):
    """Every number of the module docstring, worst over ``answers``, a
    list of (slot, Answer); ``solved`` is the float64 reference's, per
    distinct instance (:func:`reference_solutions`)."""
    out = dict(status_mismatch=0, dual_res=0.0, cert=0.0)
    for slot, ans in answers:
        rows = slot_rows(pool, slot)
        got = certificate.numbers(pool.stack(rows), ans.y, ans.w, ans.v)
        want = ["Optimal" if ok else "Unsolved"
                for ok in solved[rows].tolist()]
        out["status_mismatch"] += sum(s != w for s, w in zip(ans.status, want))
        worst(out, "dual_res", got["dual_res"])
        worst(out, "cert", torch.stack([got["primal_viol"], got["dual_viol"],
                                        got["compl"]]).amax(0))
    return out


def judge(values: dict, limits: dict):
    """[(name, value, limit)] of the compared numbers, and whether every
    one is within its limit (a NaN never is)."""
    rows = [(name, values[name], limit) for name, limit in limits.items()]
    return rows, all(v <= lim for _, v, lim in rows)
